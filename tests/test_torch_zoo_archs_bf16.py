"""Every registered architecture's prefill and 2 decode steps in bfloat16
(the smoke configs as registered), the port against the reference on the
same parameters and inputs (``test_torch_zoo_archs.py``): last-token
logits within 2e-2, the existing LM test's tolerance. jamba's are held
within 6e-2: at these inputs the reference's own bfloat16 logits differ
from its float32 ones by up to 0.055 (8 layers of Mamba, MoE and
attention rounding to bfloat16), so two correct bfloat16 runs cannot agree
within 2e-2; its float32 case holds 1e-4."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_zoo_archs import ARCHS, check_prefill_then_decode  # noqa: E402

TOL = {"jamba-v0.1-52b": 6e-2}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_bf16(arch):
    check_prefill_then_decode(arch, "bfloat16", TOL.get(arch, 2e-2))
