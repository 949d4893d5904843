"""The census of a decode step against the reference's ``compiled_flops``
(tests/_census_decode_cases.py) for the first five of the reference's
archs; the other five, and the accounting steps, are in
tests/test_torch_census_steps.py."""

import pytest
import torch

from _census_decode_cases import check_decode_flops
from repro.configs import ARCH_IDS as REF_ARCH_IDS


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", REF_ARCH_IDS[:5])
def test_decode_flops_are_the_reference_compiled_flops(arch):
    check_decode_flops(arch)
