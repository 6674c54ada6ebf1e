"""The port's spans (fal_net_torch/utils/trace.py) on the CPU: a shared null
context with no profiler, ``record_function`` events under one, where the
serving pipeline and a stage-1 training step open them, and the same
answers with the profiler on and off (the tiny model, 32x64)."""

import torch_lane  # noqa: F401  (torch's threads sized to the xdist worker)
import contextlib

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from fal_net_torch.eval.pipeline import DisparityPipeline
from fal_net_torch.models import create_model
from fal_net_torch.parallel.dryrun import SyntheticStereo
from fal_net_torch.train import Stage1Config, Trainer
from fal_net_torch.utils import trace

H, W, B, N = 32, 64, 2, 5
PREFIX = trace.PREFIX


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    return out, events


def _named(events, name):
    return [e for e in events if e.name == PREFIX + name]


def _inside(inner, outer):
    return (inner.thread == outer.thread and outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


def test_span_without_a_profiler_is_the_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    a, b = trace.span("pipeline.dispatch"), trace.span("train.loss")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a, b:  # reentrant: the pipeline's spans open inside the trainer's
        pass


def test_span_under_a_profiler_records_one_event():
    def body():
        with trace.span("train.loss"):
            return torch.ones(3) + 1

    _, events = _profiled(body)
    (loss,) = _named(events, "train.loss")
    assert loss.is_user_annotation
    assert any(e.name == "aten::add" and _inside(e, loss) for e in events)
    # the profiler is off again: the span is the null context
    assert isinstance(trace.span("train.loss"), contextlib.nullcontext)


def _pipeline():
    torch.manual_seed(0)
    model = create_model("tiny", N, device="cpu")
    return DisparityPipeline(model, batch_size=B, max_disp=20.0, device_normalize=True)


def _frames(n=3 * B):
    rng = np.random.default_rng(0)
    return [(i, rng.integers(0, 256, (H, W, 3), dtype=np.uint8)) for i in range(n)]


def test_pipeline_spans_dispatch_and_fetch_each_batch():
    pipe = _pipeline()
    out, events = _profiled(lambda: list(pipe.run(_frames())))
    assert len(out) == 3 * B
    dispatch, fetch = _named(events, "pipeline.dispatch"), _named(events, "pipeline.fetch")
    assert len(dispatch) == 3 and len(fetch) == 3
    convs = [e for e in events if e.name == "aten::convolution"]
    assert convs and all(any(_inside(c, d) for d in dispatch) for c in convs)
    # the fetch is its own span, never inside a dispatch
    assert not any(_inside(f, d) for f in fetch for d in dispatch)


def test_pipeline_answers_alike_with_the_profiler_on_and_off():
    pipe = _pipeline()
    plain = list(pipe.run(_frames()))
    traced, _ = _profiled(lambda: list(pipe.run(_frames())))
    assert [k for k, _ in plain] == [k for k, _ in traced]
    for (_, a), (_, b) in zip(plain, traced):
        np.testing.assert_array_equal(a, b)


def _trainer():
    cfg = Stage1Config(model="tiny", num_levels=N, crop_size=(H, W), batch_size=B, a_p=0.01, allow_random_vgg=True,
                       workers=1, med_selfcheck=False, max_disp=20.0)
    tr = Trainer(cfg, stage="stage1", device="cpu", train_dataset=SyntheticStereo(B, H, W))
    tr.setup()
    assert tr.vgg is not None
    return tr


def _batch():
    data = SyntheticStereo(B, H, W, seed=3)
    pairs = [data.get(i) for i in range(B)]
    return {k: torch.from_numpy(np.stack([p[k] for p in pairs]).transpose(0, 3, 1, 2).copy())
            for k in ("left", "right")}


@pytest.fixture(scope="module")
def traced_step():
    plain, traced = _trainer(), _trainer()
    aux = plain.train_step(_batch())
    traced_aux, events = _profiled(lambda: traced.train_step(_batch()))
    return plain, aux, traced, traced_aux, events


@pytest.mark.parametrize("name", ["train.loss", "train.backward", "train.optimizer", "train.aux"])
def test_train_step_spans_each_part_once(traced_step, name):
    events = traced_step[4]
    assert len(_named(events, name)) == 1


def test_perceptual_spans_sit_in_the_loss(traced_step):
    events = traced_step[4]
    (loss,) = _named(events, "train.loss")
    perceptual = _named(events, "loss.perceptual")
    # the label's features and the composited view's, both VGG19 calls of the loss
    assert len(perceptual) == 2 and all(_inside(p, loss) for p in perceptual)
    assert all(any(e.name == "aten::convolution" and _inside(e, p) for e in events) for p in perceptual)


def test_train_step_alike_with_the_profiler_on_and_off(traced_step):
    plain, aux, traced, traced_aux, _ = traced_step
    assert aux == traced_aux and all(np.isfinite(v) for v in aux.values())
    for (n, a), (_, b) in zip(plain.model.named_parameters(), traced.model.named_parameters()):
        assert torch.equal(a, b), n
