"""An installed fal_net_torch can build its kernels: every file a CUDA
source includes is shipped as package data, and the build directory can be
moved out of a read-only package directory."""

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
    sources = sorted(glob.glob(os.path.join(_build.CSRC_DIR, "*.cu*")))
    assert sources
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
