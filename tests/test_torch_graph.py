"""The serving pipeline's forward replayed from a CUDA graph
(eval/pipeline.py), and the constants it needs on the device.

On the CPU: the flow plane's cached value (``models/falnet.py::_flow_value``)
equals the tensor path's ``float32(max_disp) / 100`` and is one tensor per
(value, device); a CPU pipeline (and a mesh) stays eager; and the
benchmark's ``graph_replay_share`` reader on hand-made reductions of a
traced window.

On a card (``cuda`` marker): graphed against eager pipelines on the same
model and frames (FAL_netB N=49 and the tiny model, B = 1 and 3, a ragged
zero-padded tail, ``ms_post_process``, ``quantize_uint16``, bf16), one
capture a shape, every answer already handed back left as it was, and K1's
launch counter against the profiler's ``med_fwd_kernel`` launches.
"""

from torch_lane import cuda_device  # noqa: F401  (cuda_device: a fixture)
import types

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from fal_net_torch.data.transforms import normalize
from fal_net_torch.eval.pipeline import DisparityPipeline
from fal_net_torch.models import create_model
from fal_net_torch.models.falnet import _flow_value
from fal_net_torch.ops import _build
from fal_net_torch.utils import trace
from portbench import run as harness

H, W = 64, 128
CPU = torch.device("cpu")


def _frames(n, h=H, w=W, seed=0):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, 256, (h, w, 3), dtype=np.uint8)) for i in range(n)]


# ---- on the CPU ----


@pytest.mark.parametrize("max_disp", [300.0, 30, 2.0, 1.0 / 3.0, 255.9])
def test_flow_value_is_the_tensor_paths_and_cached(max_disp):
    got = _flow_value(float(max_disp), CPU)
    want = torch.as_tensor(max_disp, dtype=torch.float32) / 100.0
    assert got.dtype == torch.float32 and got.ndim == 0
    assert torch.equal(got, want)
    assert _flow_value(float(max_disp), CPU) is got


def test_logits_with_a_number_bound_equal_the_tensor_path():
    """A number bound (the cached flow value) and the same bound as a 0-d or
    per-sample tensor (the path that uploads it) give the same logits, bit
    for bit."""
    torch.manual_seed(0)
    model = create_model("tiny", 5, device="cpu").eval()
    x = torch.randn(2, 3, 32, 64)
    with torch.no_grad():
        by_number = model.logits(x, 30.0)
        assert torch.equal(by_number, model.logits(x, torch.tensor(30.0)))
        assert torch.equal(by_number, model.logits(x, torch.tensor([30.0, 30.0])))
        assert not torch.equal(by_number, model.logits(x, torch.tensor([30.0, 20.0])))


def test_a_cpu_pipeline_stays_eager():
    torch.manual_seed(0)
    model = create_model("tiny", 5, device="cpu")
    frames = _frames(5, 32, 64)
    for mesh in (["cpu", "cpu"], None):
        pipe = DisparityPipeline(model, batch_size=2, max_disp=20.0, device_normalize=True, mesh=mesh)
        got = list(pipe.run(frames))
        assert not pipe._graphed and pipe.captures == 0 and pipe.replays == 0
        assert [k for k, _ in got] == [k for k, _ in frames]
    want = pipe._forward(torch.from_numpy(np.stack([frames[0][1], frames[1][1]])))[0].numpy()
    np.testing.assert_array_equal(got[0][1], want)


def _window(host, ops):
    reduced = {"ops": ops, "host": sorted(host, key=lambda t: (t[1], -t[2])), "t0_us": 0.0, "window_us": 1000.0,
               "busy_us": sum(e - s for _, s, e in ops)}
    return types.SimpleNamespace(trace=reduced, calls={"med_fwd": {}})


REPLAYED = [
    ("portbench.window", 0.0, 1000.0),
    ("fal_net_torch.pipeline.dispatch", 10.0, 60.0),
    ("fal_net_torch.pipeline.replay", 20.0, 40.0),
    ("cudaGraphLaunch", 21.0, 39.0),
    ("fal_net_torch.pipeline.fetch", 100.0, 300.0),
]
K1 = [("conv", 45.0, 50.0), ("med_fwd_kernel<true, false, false>(...)", 60.0, 70.0)]


def test_graph_replay_share_reads_replays_over_model_calls():
    read = harness.reader("graph_replay_share.frame")
    assert read(_window(REPLAYED, K1)) == pytest.approx(100.0)
    # two model calls, one replayed
    two = K1 + [("med_fwd_kernel<true, false, false>(...)", 500.0, 510.0)]
    assert read(_window(REPLAYED, two)) == pytest.approx(50.0)
    # an eager window: the dispatch span but no replay span
    eager = [h for h in REPLAYED if h[0] not in ("fal_net_torch.pipeline.replay", "cudaGraphLaunch")]
    assert read(_window(eager, K1)) is None
    # no model call in the window, and no trace at all
    assert read(_window(REPLAYED, [("conv", 45.0, 50.0)])) is None
    assert read(types.SimpleNamespace(trace=None, calls={"med_fwd": {}})) is None
    assert harness.reader("graph_replay_share.serve") is not None


# ---- on the card (marked cuda; the GPU lane runs without tests/conftest.py) ----


def _model(variant, levels, device, dtype=torch.float32):
    return create_model(variant, levels, device=device, dtype=dtype,
                        generator=torch.Generator().manual_seed(7)).eval()


def _pair(model, **kw):
    """(graphed, eager) pipelines of ``model`` with the same options."""
    graphed, eager = DisparityPipeline(model, **kw), DisparityPipeline(model, **kw)
    eager._graphed = False
    assert graphed._graphed
    return graphed, eager


CASES = [
    ("tiny", 9, 1, dict(device_normalize=True)),
    ("tiny", 9, 3, dict(ms_post_process=True, quantize_uint16=True)),
    ("B", 49, 1, dict(device_normalize=True)),
    ("B", 49, 3, dict(device_normalize=True, quantize_uint16=True)),
    ("B", 49, 3, dict(device_normalize=True, ms_post_process=True)),
    ("B", 49, 3, dict(device_normalize=True, dtype=torch.bfloat16)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("variant,levels,batch,opts", CASES,
                         ids=[f"{v}-b{b}-{'-'.join(map(str, o.values()))}" for v, _, b, o in CASES])
def test_graphed_pipeline_equals_eager(cuda_device, variant, levels, batch, opts):
    """Bit-equal in every case (the same kernels in the same order); the
    limit is 1e-4 px.  2B + 1 frames: the last batch's tail is zeros."""
    opts = dict(opts)
    model = _model(variant, levels, cuda_device, opts.pop("dtype", torch.float32))
    graphed, eager = _pair(model, batch_size=batch, max_disp=250.0, **opts)
    raw = _frames(2 * batch + 1)
    frames = raw if opts.get("device_normalize") else [(k, normalize(v)) for k, v in raw]
    got, want = list(graphed.run(frames)), list(eager.run(frames))
    assert [k for k, _ in got] == [k for k, _ in want] == [k for k, _ in frames]
    for (k, a), (_, b) in zip(got, want):
        assert a.shape == (H, W) and np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4, err_msg=str(k))
    # the first batch runs eagerly; the second captures and replays, the third replays
    assert graphed.captures == 1 and graphed.replays == 2
    assert eager.captures == 0 and eager.replays == 0


def _k1_launches():
    return sum(n for k, n in _build.launch_counts().items() if k.startswith("med_fwd:"))


@pytest.mark.cuda
def test_one_capture_a_shape_and_a_replay_a_batch(cuda_device):
    """A shape's first batch runs eagerly (the warm-up); its second is
    captured and replayed, and every later batch of it replays.  K1
    launches once a batch, the warm-up's included and the capture's not."""
    pipe = DisparityPipeline(_model("tiny", 9, cuda_device), batch_size=2, device_normalize=True)
    before = _k1_launches()
    list(pipe.run(_frames(5)))
    assert (pipe.captures, pipe.replays) == (1, 2) and _k1_launches() - before == 3
    list(pipe.run(_frames(4, seed=1)))  # the same shape: no capture
    assert (pipe.captures, pipe.replays) == (1, 4)
    list(pipe.run(_frames(3, 32, 96)))  # a new shape: its own warm-up and graph
    assert (pipe.captures, pipe.replays) == (2, 5)
    list(pipe.run(_frames(2)))  # back to the first
    assert (pipe.captures, pipe.replays) == (2, 6) and _k1_launches() - before == 3 + 2 + 2 + 1


@pytest.mark.cuda
def test_answers_handed_back_are_never_overwritten(cuda_device):
    """Every batch writes the graph's one static output; each answer is
    checked after the two batches behind it have run."""
    pipe = DisparityPipeline(_model("B", 49, cuda_device), batch_size=1, device_normalize=True)
    kept = []
    for k, disp in pipe.run(_frames(6)):
        kept.append((disp, disp.copy()))
        for old, copy in kept:
            np.testing.assert_array_equal(old, copy, err_msg=f"an answer changed at frame {k}")
    assert len({a.tobytes() for a, _ in kept}) == 6  # distinct frames, distinct answers
    assert pipe.replays == 5


@pytest.mark.cuda
@pytest.mark.parametrize("ms", [False, True])
def test_k1_counter_counts_replays_as_the_profiler_does(cuda_device, ms):
    """After the warm-up and the capture (outside the profiler), a replayed batch advances
    K1's counter by its launches (1, 2 with the multi-scale pass), and over a
    traced loop the counter equals the profiler's ``med_fwd_kernel``
    launches: the profiler sees the graph's kernels."""
    pipe = DisparityPipeline(_model("B", 49, cuda_device), batch_size=1, device_normalize=True,
                             ms_post_process=ms)
    frames = _frames(5)
    per = 2 if ms else 1
    list(pipe.run(frames[:1]))  # the warm-up, eager: nothing captured
    assert (pipe.captures, pipe.replays) == (0, 0)
    before = _k1_launches()
    list(pipe.run(frames[:1]))  # the capture, and its first replay
    assert (pipe.captures, pipe.replays) == (1, 1) and _k1_launches() - before == per
    before = _k1_launches()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        list(pipe.run(frames))
        torch.cuda.synchronize()
    launched = _k1_launches() - before
    events = list(prof.events())
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and not e.is_user_annotation
               and "med_fwd_kernel" in e.name]
    # the host's spans (on the card the profiler mirrors each on the device's timeline too)
    replays = [e for e in events if e.device_type == DeviceType.CPU and e.name == trace.PREFIX + "pipeline.replay"]
    assert launched == len(frames) * per == len(kernels)
    assert len(replays) == len(frames) and pipe.captures == 1
