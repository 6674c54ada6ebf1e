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
"""

from __future__ import annotations

from typing import Iterable, Iterator, Tuple

import numpy as np
import torch

from fal_net_torch.data.transforms import normalize_device
from fal_net_torch.eval.postprocess import ms_post_process
from fal_net_torch.parallel.mesh import as_mesh, check_divides, launch, replicate
from fal_net_torch.utils.trace import span

UINT16_MAX_DISP = 65535 / 256.0


def to_fixed_point(disp: torch.Tensor) -> torch.Tensor:
    """Disparities as KITTI's 16-bit fixed point, round(d * 256) capped at
    65535, stored as int16 offset by -32768 (16-bit unsigned tensors have
    little support on the device); :func:`from_fixed_point` undoes it."""
    return (torch.round(disp * 256.0).clamp(0, 65535) - 32768).to(torch.int16)


def from_fixed_point(q: np.ndarray) -> np.ndarray:
    return (q.astype(np.float32) + 32768.0) / 256.0


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
                yield names, np.stack(imgs)
                names, imgs = [], []
        if imgs:
            pad = self.batch_size - len(imgs)
            yield names, np.stack(imgs + [np.zeros_like(imgs[0])] * pad)

    def _dispatch(self, host: np.ndarray):
        """Upload, run and start the fetch of one batch (each part on its
        device, parallel/mesh.py::launch)."""
        with span("pipeline.dispatch"):
            return launch(torch.from_numpy(host), self.replicas, self.mesh, self.device,
                          lambda model, images: [self._forward(images, model)])

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
        for names, host in self._batches(items):
            # Dispatch this batch before waiting on the previous one's fetch,
            # so that the device and the host work at the same time.
            launched = self._dispatch(host)
            if pending is not None:
                yield from self._fetch(*pending)
            pending = (names, launched)
        if pending is not None:
            yield from self._fetch(*pending)
