"""Batched streaming inference, the serving loop (counterpart of
fal_net_tpu/eval/pipeline.py::DisparityPipeline).

Packs an image stream into fixed batches, pads the ragged tail with zeros,
and yields per-image disparities in order.  On CUDA, a batch is uploaded
from pinned memory with ``non_blocking=True`` and its disparities come back
into pinned memory behind a CUDA event, so the device runs batch k while the
host hands out batch k-1: one batch of latency for the overlap.  With a
``mesh`` (parallel/mesh.py, the counterpart of JAX's ``mesh``), each batch is
split into equal contiguous parts, one per device and model replica, every
part's forward is launched from this thread, and the parts come back in
order.

On one card with no mesh and no row shard, the forward is replayed from a
CUDA graph, one a batch shape: the first batch of a shape runs the
forward eagerly on a side stream, which hands back its answer and warms the
shape up; the second captures the forward reading a static device input,
and it and every later batch of the shape upload into that input and
replay the graph, one launch where the eager forward makes a few hundred.
A run of one batch captures nothing.  The
graph runs the same kernels in the same order (K1, the logits conv, cuDNN's
convolutions); only the host's work per kernel goes.  A batch is stacked
into one of two pinned host buffers, in turns, and uploaded from there: the
buffer a batch takes was last uploaded from two batches before, whose fetch
``run`` has waited for since, so nothing is overwritten in flight (an
event says so, and is waited for only where it does not).  Each batch's
disparities are copied from the graph's static output into a fresh pinned
host tensor on the stream the graph replays on, before the next replay is
enqueued there, so the overlap, the order and every answer already handed
back stay as they are.  The graphs of one pipeline share one memory pool.
A replay launches K1 (and the other kernels) without passing through the
ops' impls that count launches: the counts a capture recorded are taken
back off, since nothing ran, and each replay adds them again
(``ops/_build.py::add_launch_counts``), so the counters still count the
launches on the card.  The CPU, a mesh, a row-sharded model and the plain
MED head (which uploads its bounds, and a capture takes no such copy) keep
the eager path.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from fal_net_torch.data.transforms import normalize_device
from fal_net_torch.eval.postprocess import ms_post_process
from fal_net_torch.ops._build import add_launch_counts, launch_counts
from fal_net_torch.parallel.mesh import Launched, as_mesh, check_divides, launch, replicate
from fal_net_torch.utils.trace import span

UINT16_MAX_DISP = 65535 / 256.0


def to_fixed_point(disp: torch.Tensor) -> torch.Tensor:
    """Disparities as KITTI's 16-bit fixed point, round(d * 256) capped at
    65535, stored as int16 offset by -32768 (16-bit unsigned tensors have
    little support on the device); :func:`from_fixed_point` undoes it."""
    return (torch.round(disp * 256.0).clamp(0, 65535) - 32768).to(torch.int16)


def from_fixed_point(q: np.ndarray) -> np.ndarray:
    return (q.astype(np.float32) + 32768.0) / 256.0


@dataclasses.dataclass
class _Graph:
    """One batch shape's forward, captured (``graph``) reading ``images`` and
    writing ``disp``; ``launches`` are the kernel launches of one replay, by
    counter name.  Batches are stacked into two pinned host buffers in turns
    (``staging``) and uploaded from there, each with the event after its
    last upload (``uploaded``)."""

    images: torch.Tensor
    staging: tuple
    uploaded: tuple
    turn: int = 0
    graph: Optional[torch.cuda.CUDAGraph] = None
    disp: Optional[torch.Tensor] = None
    launches: dict = dataclasses.field(default_factory=dict)


class DisparityPipeline:
    """Fixed-shape batched disparity inference.

    Example:
        pipe = DisparityPipeline(model, batch_size=8)
        for name, disp in pipe.run(named_images):  # (name, HW float32)
            ...
    """

    def __init__(
        self,
        model,
        batch_size: int = 8,
        min_disp: float = 2.0,
        max_disp: float = 300.0,
        ms_post_process: bool = False,
        quantize_uint16: bool = False,
        device_normalize: bool = False,
        mesh=None,
    ):
        """``model``: a :class:`fal_net_torch.models.FalNet`; the pipeline
        runs on the device its parameters are on.

        ``quantize_uint16``: fetch disparities as on-device ``round(disp *
        256)`` 16-bit values (the KITTI disparity-PNG fixed-point format)
        instead of fp32, half the device-to-host bytes; yields floats at
        1/256 px, capped at 65535/256 = 255.996 px.

        ``device_normalize``: items are raw uint8 HWC RGB; the /255 - mean
        normalization runs on the device, and the upload is 4x smaller.

        ``ms_post_process``: the reference's multi-scale post-process
        (eval/postprocess.py), a second forward at 2/3 scale on the flipped
        batch, in the same device call.

        ``mesh``: a :class:`~fal_net_torch.parallel.mesh.Mesh` or a list of
        devices (repeats allowed): one replica of ``model`` per device, each
        batch split over them; ``batch_size`` must be divisible by its
        size (ValueError, as in JAX)."""
        self.mesh = None if mesh is None else as_mesh(mesh)
        if self.mesh is not None:
            check_divides(batch_size, self.mesh)
        if quantize_uint16 and max_disp > UINT16_MAX_DISP:
            import warnings

            warnings.warn(
                f"quantize_uint16 caps fetched disparities at 65535/256 = "
                f"{UINT16_MAX_DISP:.3f} px but max_disp={max_disp} allows larger "
                "values; close-range disparities will clip.  Lower max_disp "
                "or disable quantize_uint16.",
                stacklevel=2,
            )
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.replicas = [self.model] if self.mesh is None else replicate(self.model, self.mesh)
        self.batch_size = batch_size
        self.min_disp = min_disp
        self.max_disp = max_disp
        self.ms_post_process = ms_post_process
        self.quantize_uint16 = quantize_uint16
        self.device_normalize = device_normalize
        # the forward replayed from a CUDA graph (the module docstring)
        self._graphed = (self.device.type == "cuda" and self.mesh is None and self.model.spatial.size == 1
                        and self.model.med_impl != "reference")
        self._graphs = {}
        self._pool = None
        self.captures = 0  # graphs captured
        self.replays = 0  # batches replayed from one

    @torch.inference_mode()
    def _forward(self, images: torch.Tensor, model=None) -> torch.Tensor:
        """(B, H, W, C) batch on ``model``'s device (the pipeline's model if
        None) -> (B, H, W) disparities, fp32 or in :func:`to_fixed_point`'s
        int16."""
        model = model or self.model
        disp_fn = lambda x: model(x.contiguous(), self.min_disp, self.max_disp, ret_disp=True).disp
        x = images.permute(0, 3, 1, 2)
        x = normalize_device(x) if self.device_normalize else x.to(torch.float32)
        disp = disp_fn(x)
        if self.ms_post_process:
            disp = ms_post_process(x, disp_fn, disp)
        disp = disp[:, 0]
        return to_fixed_point(disp) if self.quantize_uint16 else disp

    def _batches(self, items: Iterable[Tuple[str, np.ndarray]]):
        """(names, images) of each batch, the ragged tail padded with zeros."""
        dtype = np.uint8 if self.device_normalize else np.float32
        names, imgs = [], []
        for name, img in items:
            img = np.asarray(img)
            if self.device_normalize and img.dtype != np.uint8:
                # a silent float->uint8 cast would wrap negatives into garbage
                raise TypeError(
                    f"device_normalize=True expects uint8 images, got "
                    f"{img.dtype} for {name!r}"
                )
            names.append(name)
            imgs.append(img.astype(dtype))
            if len(imgs) == self.batch_size:
                yield names, imgs
                names, imgs = [], []
        if imgs:
            pad = self.batch_size - len(imgs)
            yield names, imgs + [np.zeros_like(imgs[0])] * pad

    def _dispatch(self, imgs: List[np.ndarray]):
        """Upload, run and start the fetch of one batch (replayed from its
        shape's graph, or each part on its device, parallel/mesh.py::launch)."""
        with span("pipeline.dispatch"):
            if self._graphed:
                return self._replay(imgs)
            return launch(torch.from_numpy(np.stack(imgs)), self.replicas, self.mesh, self.device,
                          lambda model, images: [self._forward(images, model)])

    def _replay(self, imgs: List[np.ndarray]) -> Launched:
        """Upload the batch into its shape's static input, run its forward
        and start the copy of its output to the host, all on the current
        stream of the pipeline's device.  A shape's first batch runs
        eagerly (:meth:`_warm_up`); its second captures the graph
        (:meth:`_capture`) and replays it, as every later one does.  The
        options and the model's dtype are fixed for the life of a pipeline,
        so the shape alone keys a graph."""
        shape = (len(imgs), *imgs[0].shape)
        with torch.cuda.device(self.device):
            entry = self._graphs.get(shape)
            first = entry is None
            if first:
                staging = tuple(torch.from_numpy(np.empty(shape, imgs[0].dtype)).pin_memory() for _ in range(2))
                with torch.inference_mode(False):  # a static input that later uploads may write outside it
                    images = torch.empty_like(staging[0], device=self.device)
                entry = self._graphs[shape] = _Graph(images, staging, (torch.cuda.Event(), torch.cuda.Event()))
            # The buffer of this turn was last uploaded from two batches ago,
            # before the fetch that run() waited for since: no wait but here.
            entry.turn ^= 1
            host, uploaded = entry.staging[entry.turn], entry.uploaded[entry.turn]
            if not uploaded.query():
                uploaded.synchronize()
            np.stack(imgs, out=host.numpy())
            entry.images.copy_(host, non_blocking=True)
            uploaded.record()
            if first:
                return self._warm_up(entry)
            if entry.graph is None:
                self._capture(entry)
            with span("pipeline.replay"):
                entry.graph.replay()
            add_launch_counts(entry.launches)
            self.replays += 1
            return Launched().add([entry.disp], self.device)

    def _warm_up(self, entry: _Graph) -> Launched:
        """A shape's first batch: its forward on ``entry.images`` run
        eagerly on a side stream, whose answer it hands back, so that
        cuDNN's choice of algorithm, the kernels' one-time set-up and the
        cached constants happen before any capture; a run of one batch
        captures nothing."""
        current, side = torch.cuda.current_stream(), torch.cuda.Stream()
        side.wait_stream(current)
        with torch.cuda.stream(side):
            launched = Launched().add([self._forward(entry.images)], self.device)
        current.wait_stream(side)
        return launched

    def _capture(self, entry: _Graph) -> None:
        """Capture the forward of ``entry``'s shape into ``entry``, reading
        its static input; on the pipeline's device, the current one here.
        A capture records launches and runs none, so its counts come back
        off the launch counters."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph, before = torch.cuda.CUDAGraph(), launch_counts()
        with torch.cuda.graph(graph, pool=self._pool):
            disp = self._forward(entry.images)
        launches = {k: n - before[k] for k, n in launch_counts().items() if n != before[k]}
        add_launch_counts({k: -n for k, n in launches.items()})  # recorded, not run
        entry.graph, entry.disp, entry.launches = graph, disp, launches
        self.captures += 1

    def _fetch(self, names, launched):
        # the span holds the wait alone: it must not stay open across a yield
        with span("pipeline.fetch"):
            (disp,) = launched.fetch()
        disp = disp.numpy()
        if self.quantize_uint16:
            disp = from_fixed_point(disp)
        for i, name in enumerate(names):
            yield name, disp[i]

    def run(self, items: Iterable[Tuple[str, np.ndarray]]) -> Iterator[Tuple[str, np.ndarray]]:
        """items: (name, HWC image) -> (name, HW disparity).  Images are
        /255-mean normalized float32, or raw uint8 RGB with
        ``device_normalize=True``."""
        pending = None
        for names, imgs in self._batches(items):
            # Dispatch this batch before waiting on the previous one's fetch,
            # so that the device and the host work at the same time.
            launched = self._dispatch(imgs)
            if pending is not None:
                yield from self._fetch(*pending)
            pending = (names, launched)
        if pending is not None:
            yield from self._fetch(*pending)
