"""An installed fal_net_torch can build its kernels: every file a CUDA
source or the ops' binding includes is shipped as package data, and the
build directory can be moved out of a read-only package directory.  The
binding includes no torch/extension.h (minutes of build), and no kernel
launches through ctypes.  Each of the JAX package's console scripts has a
``falnet-torch-*`` counterpart whose exit status is the command's."""

import fnmatch
import glob
import importlib
import importlib.metadata
import inspect
import os
import re
import tomllib

import pytest

from fal_net_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIS = ("train", "test", "export", "infer", "convert", "selfcheck")


def _scripts() -> dict:
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        return tomllib.load(f)["project"]["scripts"]


def _target(name: str):
    """The module and the function that ``falnet-torch-<name>`` calls,
    resolved as an installed console script's wrapper resolves it."""
    value = _scripts()[f"falnet-torch-{name}"]
    entry = importlib.metadata.EntryPoint(f"falnet-torch-{name}", value, "console_scripts").load()
    return importlib.import_module(value.split(":")[0]), entry


def test_every_included_file_is_package_data():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"]["fal_net_torch"]
    shipped = lambda rel: any(fnmatch.fnmatch(rel, g) for g in globs)
    sources = sorted(glob.glob(os.path.join(_build.CSRC_DIR, "*.c*")))  # .cu, .cuh and the binding's .cpp
    assert any(src.endswith("torch_ops.cpp") for src in sources)
    for src in sources:
        assert shipped(os.path.relpath(src, _build.PKG_DIR)), src
        with open(src) as f:
            for name in re.findall(r'^\s*#\s*include\s+"([^"]+)"', f.read(), flags=re.M):
                path = os.path.normpath(os.path.join(os.path.dirname(src), name))
                assert os.path.isfile(path), f"{src} includes a missing {name}"
                assert shipped(os.path.relpath(path, _build.PKG_DIR)), f"{name} ({src}) is not package data"


def test_build_dir_override(monkeypatch, tmp_path):
    monkeypatch.delenv(_build.BUILD_DIR_ENV, raising=False)
    assert os.path.dirname(_build.library_path()) == os.path.join(_build.PKG_DIR, "_build")
    monkeypatch.setenv(_build.BUILD_DIR_ENV, str(tmp_path / "kernels"))
    assert os.path.dirname(_build.library_path()) == str(tmp_path / "kernels")


def test_kernels_launch_through_ops_only():
    """The sources include PyTorch's light headers only, and the C entries
    are launched from the binding's C++, never from Python."""
    for src in glob.glob(os.path.join(_build.CSRC_DIR, "*.c*")):
        with open(src) as f:
            assert not re.search(r'#\s*include\s*[<"]torch/extension\.h', f.read()), src
    with open(os.path.join(_build.CSRC_DIR, "torch_ops.cpp")) as f:
        binding = f.read()
    for op in ("med_fwd", "med_bwd", "conv3x3", "roll_window", "logits_conv"):
        assert f'm.impl("{op}"' in binding, op
    assert not hasattr(_build, "launch")
    for name in ("med_kernel", "conv3x3", "roll_probe", "logits_conv"):
        with open(os.path.join(_build.PKG_DIR, "ops", f"{name}.py")) as f:
            code = f.read()
        assert "data_ptr" not in code and "torch.ops.fal_net_torch." in code, name


@pytest.mark.parametrize("name", CLIS)
def test_console_scripts_have_port_counterparts(name):
    """JAX's ``falnet-<name>`` is unchanged and ``falnet-torch-<name>``
    names the port's CLI module of the same name."""
    scripts = _scripts()
    assert scripts[f"falnet-{name}"] == f"fal_net_tpu.cli.{name}:main"
    module, func = scripts[f"falnet-torch-{name}"].split(":")
    assert module == f"fal_net_torch.cli.{name}" and func in ("main", "run")
    assert sorted(k for k in scripts if k.startswith("falnet-torch-")) == sorted(f"falnet-torch-{c}" for c in CLIS)


@pytest.mark.parametrize("name", CLIS)
def test_console_script_help_exits_0(name, capsys):
    _, entry = _target(name)
    with pytest.raises(SystemExit) as e:
        entry(["--help"])
    assert e.value.code == 0
    assert "usage:" in capsys.readouterr().out


@pytest.mark.parametrize("name", CLIS)
def test_console_script_exit_status_is_the_commands(name, monkeypatch):
    """A console script passes its function's result to ``sys.exit``, which
    takes anything but None or 0 for a failure.  A ``main`` that returns
    something (the trainer's result, the metrics, a path, a count) is
    reached through ``run``, which returns None; a ``main`` that returns
    nothing is the entry itself."""
    module, entry = _target(name)
    if inspect.signature(module.main).return_annotation in (None, "None"):
        assert entry is module.main
        return
    assert entry is module.run
    calls = []
    monkeypatch.setattr(module, "main", lambda argv=None: calls.append(argv) or {"loss": 0.5})
    assert entry(["--x"]) is None and calls == [["--x"]]
