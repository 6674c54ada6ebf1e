"""An installed fal_net_torch can build its kernels: every file a CUDA
source or the ops' binding includes is shipped as package data, and the
build directory can be moved out of a read-only package directory.  The
binding includes no torch/extension.h (minutes of build), and no kernel
launches through ctypes."""

import fnmatch
import glob
import os
import re
import tomllib

from fal_net_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    for op in ("med_fwd", "med_bwd", "conv3x3", "roll_window"):
        assert f'm.impl("{op}"' in binding, op
    assert not hasattr(_build, "launch")
    for name in ("med_kernel", "conv3x3", "roll_probe"):
        with open(os.path.join(_build.PKG_DIR, "ops", f"{name}.py")) as f:
            code = f.read()
        assert "data_ptr" not in code and "torch.ops.fal_net_torch." in code, name
