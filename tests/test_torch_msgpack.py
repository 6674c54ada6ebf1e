"""JAX msgpack checkpoints in the port: ``fal_net_torch/models/msgpack.py``
against flax's own ``msgpack_restore`` on what ``flax.serialization`` writes,
and ``models/checkpoint.py`` on every form of JAX's ``save_checkpoint`` (a
TrainState, ``model_best``, a bare params dict, a variables dict, a run
directory with its sidecar, a bad structure) against the ``.pt`` of the
same weights: state_dicts equal array for array, forwards equal exactly."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from fal_net_tpu.models import create_model as jax_create_model
from fal_net_tpu.train.checkpoint import load_params_any, save_checkpoint as jax_save_checkpoint
from fal_net_tpu.train.state import create_train_state
from fal_net_torch.cli import convert as cli_convert
from fal_net_torch.cli import train as train_cli
from fal_net_torch.models import checkpoint, msgpack
from fal_net_torch.models.jax_import import state_dict_from_jax
from test_torch_train import _write_tree

N, H, W = 5, 32, 64


def _assert_tree_equal(got, want, path="root"):
    assert type(got) is type(want) or (isinstance(want, np.generic) and np.asarray(got).dtype == want.dtype), \
        (path, type(got), type(want))
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want or (want != want and got != got), (path, got, want)


def test_decoder_matches_flax(rng, monkeypatch):
    """Every msgpack type flax writes, at each of its widths, and flax's ext
    types and chunked arrays, decode as flax.serialization decodes them."""
    tree = {
        "ints": {str(i): v for i, v in enumerate([0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
                                                  2**63, -1, -32, -33, -128, -129, -32768, -32769, -2**31,
                                                  -2**31 - 1, -2**63])},
        "floats": {"a": 1.5, "b": -0.0, "c": float("inf"), "d": 1e300},
        "strs": {"short": "x", "mid": "y" * 40, "long": "z" * 300, "wide": "é" * 70000, "empty": ""},
        "bin": b"\x00\x01" * 200,
        "flags": {"t": True, "f": False, "n": None},
        "list": [1, "two", [3.0, None]],
        "arrays": {dt: (rng.standard_normal((2, 3)) * 100).astype(dt)
                   for dt in ("float32", "float64", "float16", "int8", "int32", "int64", "uint8", "uint16", "bool")},
        "empty": np.zeros((0, 4), np.float32),
        "scalar0d": np.zeros((), np.float32) + 3,
        "npscalar": np.float32(2.5),
        "npint": np.int64(-7),
        "complex": 1.5 - 2j,
        "big": rng.standard_normal(1000).astype(np.float32),
    }
    tree["map16"] = {f"k{i}": i for i in range(20)}
    tree["arr16"] = list(range(20))
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)  # "big" (4000 bytes) is written in chunks
    blob = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in blob
    _assert_tree_equal(msgpack.msgpack_restore(blob), serialization.msgpack_restore(blob))


def test_decoder_widens_bfloat16_exactly(rng):
    x = jnp.asarray(rng.standard_normal((3, 5)), jnp.bfloat16)
    got = msgpack.msgpack_restore(serialization.msgpack_serialize({"w": np.asarray(x)}))["w"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(x.astype(jnp.float32)))


@pytest.mark.parametrize("blob", [b"\xc1", b"\x92\x01", b"\x01\x02", b"\xd4\x07\x00", b"\x81\x90\x01"])
def test_decoder_raises_on_what_it_does_not_cover(blob):
    """A reserved type byte, a truncated array, trailing bytes, an unknown
    ext type and an unhashable key raise ValueError."""
    with pytest.raises(ValueError):
        msgpack.unpackb(blob)


@pytest.fixture(scope="module")
def jax_tiny():
    model = jax_create_model("tiny", N, med_impl="reference", s2d_stem=False, stem_input_fuse=False,
                             stem_flow_analytic=False, phase_deconv=False)
    variables = model.init(jax.random.PRNGKey(3), jnp.zeros((1, H, W, 3)), 2.0, 300.0, ret_disp=True)
    return model, jax.device_get(variables)


def _pt(tmp_path, variables, variant="tiny"):
    model = checkpoint.create_model(variant, N, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict_from_jax(variables["params"],
                                                                                  variant).items()})
    path = str(tmp_path / "want.pt")
    checkpoint.save_checkpoint(path, model)
    return path


def _forms(tmp_path, model, variables):
    """JAX's save_checkpoint of each form, as (path, expects the sidecar)."""
    state = create_train_state(model, variables, lr=1e-4, beta1=0.5, beta2=0.999, milestones=(30, 40),
                               lr_gamma=0.5, steps_per_epoch=10)
    meta = {"epoch": 0, "step": 0, "model_name": "FAL_netTiny", "num_levels": N}
    forms = {}
    run = str(tmp_path / "run")
    jax_save_checkpoint(run, jax.device_get(state), meta, is_best=True)  # a TrainState and model_best
    forms["train_state"] = os.path.join(run, "checkpoint.msgpack")
    forms["model_best"] = os.path.join(run, "model_best.msgpack")
    forms["run_dir"] = run
    for name, target in (("variables", variables), ("bare_params", variables["params"])):
        path = str(tmp_path / name / "weights.msgpack")  # no sidecar: the variant from the shapes
        os.makedirs(os.path.dirname(path))
        with open(path, "wb") as f:
            f.write(serialization.to_bytes(target))
        forms[name] = path
    return forms


def test_every_jax_form_loads_as_the_pt(tmp_path, jax_tiny, rng):
    model, variables = jax_tiny
    want_path = _pt(tmp_path, variables)
    want = checkpoint.read_state_dict(want_path)
    x = torch.from_numpy((rng.standard_normal((1, 3, H, W)) * 0.3).astype(np.float32))
    with torch.no_grad():
        want_out = checkpoint.load_checkpoint(want_path, device="cpu")(x, 2.0, 300.0, ret_disp=True, ret_pan=True)
    for form, path in _forms(tmp_path, model, variables).items():
        got = checkpoint.read_state_dict(path)
        assert got.keys() == want.keys(), form
        for k in want:
            assert got[k].dtype == want[k].dtype, (form, k)
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=f"{form} {k}")
        port, variant, levels = checkpoint.load_model_any(path, device="cpu")
        assert (variant, levels) == ("tiny", N), form
        with torch.no_grad():
            out = port(x, 2.0, 300.0, ret_disp=True, ret_pan=True)
        for name in ("disp", "pan"):
            torch.testing.assert_close(getattr(out, name), getattr(want_out, name), rtol=0, atol=0)
        # what JAX's own reader makes of the same file
        jax_vars, name, jax_levels = load_params_any(path)
        assert (name is None) == (form in ("variables", "bare_params")) and jax_levels in (None, N)


def test_sidecar_names_the_variant_and_planes(tmp_path):
    """The sidecar's model_name and num_levels win; without one, the variant
    comes from the encoder widths (A's separable residuals included)."""
    model = jax_create_model("A", 9, med_impl="reference", s2d_stem=False, stem_input_fuse=False,
                             stem_flow_analytic=False, phase_deconv=False)
    variables = jax.device_get(model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 128, 3)), 2.0, 300.0,
                                          ret_disp=True))
    jax_save_checkpoint(str(tmp_path / "a"), variables["params"], {"model_name": "FAL_netA", "num_levels": 9})
    port, variant, levels = checkpoint.load_model_any(str(tmp_path / "a"), device="cpu")
    assert (variant, levels, port.spec.torch_name) == ("A", 9, "FAL_netA")
    with open(tmp_path / "bare.msgpack", "wb") as f:
        f.write(serialization.to_bytes(variables["params"]))
    assert checkpoint.load_model_any(str(tmp_path / "bare.msgpack"), device="cpu")[1:] == ("A", 9)
    out = cli_convert.main(["--input", str(tmp_path / "a" / "checkpoint.msgpack"), "--output", str(tmp_path / "c")])
    assert json.loads((tmp_path / "c" / "checkpoint.json").read_text()) == {"model_name": "FAL_netA", "num_levels": 9}
    got = checkpoint.read_state_dict(out)
    for k, v in state_dict_from_jax(variables["params"], "A").items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_bad_structure_raises(tmp_path):
    """The ValueError of JAX's load_params_any, on both sides."""
    path = str(tmp_path / "bad.msgpack")
    with open(path, "wb") as f:
        f.write(serialization.to_bytes({"weights": {"w": np.zeros(3, np.float32)}}))
    with pytest.raises(ValueError, match="unrecognized checkpoint structure"):
        load_params_any(path)
    with pytest.raises(ValueError, match="unrecognized checkpoint structure"):
        checkpoint.read_state_dict(path)


def test_cli_train_warm_starts_from_jax(tmp_path, jax_tiny):
    """cli.train --pretrained <JAX run directory>: the first step starts from
    JAX's weights (checked through the saved run's Adam step from them)."""
    model, variables = jax_tiny
    run = str(tmp_path / "jax_run")
    jax_save_checkpoint(run, variables, {"model_name": "FAL_netTiny", "num_levels": N})
    root = _write_tree(tmp_path, n_pairs=2)
    result = train_cli.main(["--data_root", root, "--lists_dir", root, "--model", "tiny", "--no_levels", str(N),
                             "--a_p", "0", "--device", "cpu", "--epochs", "1", "--batch_size", "2", "--lr", "0",
                             "--crop_height", str(H), "--crop_width", str(W), "--workers", "1",
                             "--pretrained", run, "--save_path", str(tmp_path / "runs")])
    saved = checkpoint.read_state_dict(result["checkpoint"])
    for k, v in state_dict_from_jax(variables["params"], "tiny").items():
        np.testing.assert_array_equal(saved[k].numpy(), v, err_msg=k)  # lr 0: the weights as loaded
