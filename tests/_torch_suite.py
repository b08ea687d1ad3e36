"""The rules by which a test module of links_tpu_torch runs beside the
others on the suite's workers: one CPU thread, and the full-width artifacts
of its trainer runs removed when their user ends.

Every ``tests/test_torch_*.py`` but the card's ``test_torch_cuda.py`` takes
the thread rule by importing ``one_cpu_thread`` (pytest applies an imported
autouse fixture to the importing module). A test or module fixture whose
runs write full-width checkpoints takes ``scratch`` or ``module_scratch`` in
place of ``tmp_path`` or ``tmp_path_factory``; a module that uses a fixture
imported from another module, which takes one of these, imports it too.
Like ``tests/_torch_dp.py``, this module imports no jax and nothing of
``links_tpu``."""

import contextlib
import os
import shutil

import pytest
import torch


@contextlib.contextmanager
def one_thread():
    """One CPU thread in this process and in each process it spawns while the
    block runs; the settings are restored after. The suite's workers share
    the cores, and torch's default of a thread per core in each would
    oversubscribe them several times over."""
    threads, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        if env is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = env


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """The whole importing module, its module fixtures included, under
    ``one_thread`` (restored for the module that runs next on the worker,
    which may be one of the JAX package's)."""
    with one_thread():
        yield


@pytest.fixture
def scratch(tmp_path):
    """``tmp_path``, removed after the test (trainer runs write full-width
    checkpoints: hundreds of MB a test)."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def module_scratch(tmp_path_factory):
    """``-> mktemp(name)``: ``tmp_path_factory.mktemp`` for module fixtures
    whose runs write full-width checkpoints; every directory it made is
    removed when the module ends."""
    made = []

    def mktemp(name: str):
        made.append(tmp_path_factory.mktemp(name))
        return made[-1]

    yield mktemp
    for path in made:
        shutil.rmtree(path, ignore_errors=True)
