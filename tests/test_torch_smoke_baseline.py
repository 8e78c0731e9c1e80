"""chip_smoke.py's --baseline loader, on this repo's own tree: the tree's
magnetite_tpu_torch is imported apart from the one under test, its kernel
library lies under that tree, and the package under test keeps its launch
counter and library handle. Nothing is built or loaded: the loader only
imports, and the other tree's cuda_lib builds at its first launch."""

import importlib
import os

import chip_smoke
import magnetite_tpu_torch
from magnetite_tpu_torch.kernels import cuda_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_baseline_loader_imports_the_tree_apart_and_builds_nothing():
    counter, lib = cuda_lib.launches.copy(), cuda_lib._lib
    base = chip_smoke.load_baseline(REPO)
    base_lib = importlib.import_module(f"{base.__name__}.kernels.cuda_lib")
    assert base is not magnetite_tpu_torch and base.__name__ != magnetite_tpu_torch.__name__
    assert base_lib is not cuda_lib and base_lib.launches is not cuda_lib.launches
    assert base_lib.SO_PATH.startswith(os.path.join(REPO, ""))
    assert base_lib._lib is None  # the other tree's library neither built nor loaded
    assert cuda_lib.launches == counter and cuda_lib._lib is lib
    assert chip_smoke.load_baseline(REPO) is base
