"""Device meshes for one-process data parallelism (counterpart of
fal_net_tpu/parallel/mesh.py).

JAX's ``'data'`` mesh shards a batch over devices inside one jitted program.
The port's mesh is the list of devices that one process drives: evaluation
and serving keep one model replica per device, split each batch into equal
contiguous parts (:func:`split_batch`), launch every part's forward from the
calling thread (launches are asynchronous, so the devices overlap) and
concatenate the parts back in order (:func:`gather`); :func:`launch` does
all three for the Evaluator and the DisparityPipeline.  A mesh may repeat a
device (``["cpu", "cpu"]``, or ``["cuda:0", "cuda:0"]`` on a one-card
machine): its replicas then share one model.  Training runs one process per
card under DistributedDataParallel instead (parallel/ddp.py).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch

from fal_net_torch.utils.device import place, resolve_device

Device = Union[str, torch.device]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D ``'data'`` mesh over ``devices`` (repeats allowed)."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    def distinct(self) -> List[torch.device]:
        """Each device once, in mesh order."""
        return list(dict.fromkeys(self.devices))


def _canonical(device: Device) -> torch.device:
    d = resolve_device(device)
    return torch.device("cuda", torch.cuda.current_device() if d.index is None else d.index) if d.type == "cuda" else d


def visible_cards() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def make_mesh(num_devices: Optional[int] = None, devices: Optional[Sequence[Device]] = None,
              device: Device = "cuda") -> Mesh:
    """A mesh over ``devices`` (their first ``num_devices``), or over the
    first ``num_devices`` cards (all visible cards if None).  With
    ``device="cpu"`` and no ``devices``, ``num_devices`` CPU replicas (1 if
    None).  More devices than there are raises ValueError, naming both
    numbers: JAX's ``devs[:n]`` shrinks in silence, the port does not.
    Asking for cards where there is none raises as every entry point does."""
    if devices is not None:
        devs = [_canonical(d) for d in devices]
    elif torch.device(device).type == "cpu":
        devs = [torch.device("cpu")] * (num_devices or 1)
    else:
        resolve_device(device)  # no card: the port's device rule raises
        devs = [torch.device("cuda", i) for i in range(visible_cards())]
    if num_devices is not None:
        if num_devices < 1 or num_devices > len(devs):
            what = "devices given" if devices is not None else "visible CUDA devices"
            raise ValueError(f"a mesh of {num_devices} devices was asked for, but there are {len(devs)} {what}")
        devs = devs[:num_devices]
    return Mesh(tuple(devs))


def make_mesh_for_batch(batch_size: int, device: Device = "cuda") -> Mesh:
    """The largest mesh (at most the visible cards; one CPU replica for
    ``device="cpu"``) whose size divides the global batch, as JAX's rule
    (fal_net_tpu/parallel/mesh.py:34-43)."""
    n = 1 if torch.device(device).type == "cpu" else max(visible_cards(), 1)
    while n > 1 and batch_size % n != 0:
        n -= 1
    return make_mesh(n, device=device)


def as_mesh(mesh) -> Mesh:
    """A :class:`Mesh`, or a sequence of devices made into one."""
    return mesh if isinstance(mesh, Mesh) else make_mesh(devices=list(mesh))


def check_divides(batch_size: int, mesh: Mesh) -> None:
    """The ValueError of JAX's Evaluator and pipeline (evaluate.py:124-128,
    pipeline.py:91-95) for a batch the mesh does not divide."""
    if batch_size % mesh.size != 0:
        raise ValueError(f"batch_size {batch_size} is not divisible by the mesh 'data' axis size {mesh.size} "
                         f"(mesh {{'data': {mesh.size}}})")


def split_batch(batch: torch.Tensor, mesh: Mesh, non_blocking: bool = False) -> List[torch.Tensor]:
    """``batch`` in ``mesh.size`` equal contiguous parts along dim 0, part
    *i* on ``mesh.devices[i]`` (copies issued without blocking where the
    source is pinned)."""
    check_divides(batch.shape[0], mesh)
    return [part.to(dev, non_blocking=non_blocking) for part, dev in zip(batch.chunk(mesh.size), mesh.devices)]


def gather(parts: Sequence[torch.Tensor], device: Optional[Device] = None) -> torch.Tensor:
    """The parts concatenated in order along dim 0 on ``device`` (the first
    part's device if None)."""
    device = parts[0].device if device is None else torch.device(device)
    return torch.cat([p.to(device) for p in parts])


def replicate(model: torch.nn.Module, mesh: Mesh) -> List[torch.nn.Module]:
    """One model per mesh position: ``model`` itself on its own device, one
    copy on each other distinct device, shared by that device's repeats."""
    home = next(model.parameters()).device
    by_device = {home: model}
    for d in mesh.distinct():
        if d not in by_device:
            by_device[d] = place(copy.deepcopy(model), d).eval()
    return [by_device[d] for d in mesh.devices]


@dataclasses.dataclass
class Launched:
    """A batch's outputs on their way to the host: each part's host copies,
    and the events that say they have landed (none off the card)."""

    parts: List[List[torch.Tensor]] = dataclasses.field(default_factory=list)
    events: List[torch.cuda.Event] = dataclasses.field(default_factory=list)

    def add(self, tensors: Sequence[torch.Tensor], device: torch.device) -> Launched:
        """Start the copies of one part's ``tensors`` (on ``device``) to the
        host: pinned, without blocking and behind an event on ``device``'s
        current stream where it is a card."""
        cuda = device.type == "cuda"
        self.parts.append([t.to("cpu", non_blocking=cuda) for t in tensors])  # pinned when non_blocking
        if cuda:
            self.events.append(torch.cuda.Event())
            self.events[-1].record(torch.cuda.current_stream(device))
        return self

    def fetch(self) -> List[torch.Tensor]:
        """Wait for the copies; each output with its parts gathered in order."""
        for event in self.events:
            event.synchronize()
        return [parts[0] if len(parts) == 1 else gather(parts) for parts in zip(*self.parts)]


def launch(batch: torch.Tensor, replicas: Sequence[torch.nn.Module], mesh: Optional[Mesh], device: torch.device,
           fn: Callable[[torch.nn.Module, torch.Tensor], Sequence[torch.Tensor]]) -> Launched:
    """Upload the host ``batch`` (pinned, without blocking, where ``device``
    is a card), whole to ``device`` without a mesh or split over ``mesh``;
    run ``fn(replicas[i], part i)`` for every part from this thread (each
    launch returns at once, so the devices overlap) and start the copies
    of the tensors it returns to the host.  Nothing waits for a device."""
    cuda = device.type == "cuda"
    if cuda:
        batch = batch.pin_memory()
    parts = [batch.to(device, non_blocking=cuda)] if mesh is None else split_batch(batch, mesh, non_blocking=cuda)
    launched = Launched()
    for model, part in zip(replicas, parts):
        launched.add(fn(model, part), part.device)
    return launched
