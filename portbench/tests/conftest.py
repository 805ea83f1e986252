"""Fixtures of the benchmark's tests: the card, decided inside a fixture
(never while a module is imported), and the toy copy of the benchmark."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="session")
def toy_root(tmp_path_factory):
    from portbench.tests import toy
    return toy.make_copy(str(tmp_path_factory.mktemp("toy")))
