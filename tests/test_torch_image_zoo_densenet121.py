"""The float32 SGD step and eval of densenet121 held against the JAX
reference at cifar10 width: test_torch_image_zoo.py's
``test_cifar10_step_and_eval_match_jax`` for this arch, in a file of its
own so that pytest-xdist's ``--dist loadfile`` runs it, the suite's
slowest case, beside the rest of the zoo's cases rather than after them
on one worker.
"""

import torch_threads  # noqa: F401  (first: the test process's threads)

import pytest

from test_torch_image_zoo import check_step_and_eval

pytestmark = pytest.mark.torchport


@pytest.mark.parametrize("arch", ("densenet121",))
def test_cifar10_step_and_eval_match_jax(arch, monkeypatch):
    check_step_and_eval(arch, monkeypatch)
