"""The port's CUDA kernels against their plain PyTorch versions on a card.

Every test here needs a CUDA card and is marked `gpu`; without one it
skips. The file imports no JAX, so it runs on a machine with the card and
no JAX (the repository's conftest.py configures JAX, hence --noconftest):

    python -m pytest tests/test_torch_cuda.py --noconftest -m gpu

Tolerance: max|kernel - plain| / max|plain| <= 1e-4 in fp32 (TF32 off: the
two differ in summation order only) and 2e-2 in bf16 (the kernels round
the attention probabilities and the FF intermediate to bf16 where the
plain versions keep other roundings)."""

import pytest
import torch

from rcdms_tpu_torch import ops
from rcdms_tpu_torch.ops.flash import attention_plain, flash_attention
from rcdms_tpu_torch.ops.frame_attention import (
    frame_attention,
    frame_attention_plain,
)
from rcdms_tpu_torch.ops.geglu import (
    geglu_ff,
    geglu_ff_plain,
    gelu_ff,
    gelu_ff_plain,
)

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, not at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(out, ref):
    return ((out.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain(cuda, dtype):
    """Each kernel against its plain version at small shapes with ragged
    edges (200 queries, 91 keys, 97 tokens, 70 rows)."""
    g = torch.Generator(cuda).manual_seed(0)

    def r(*s, scale=1.0):
        return (torch.randn(s, generator=g, device=cuda) * scale).to(dtype)

    ops.reset_launch_counts()
    q, k, v = r(3, 200, 80), r(3, 91, 80), r(3, 91, 80)
    # dh 40: the tensor-core kernel in bf16; dh 20: the CUDA-core one
    for heads in (2, 4):
        dh = 80 // heads
        assert _rel(flash_attention(q, k, v, heads),
                    attention_plain(q, k, v, heads, dh ** -0.5)) <= TOL[dtype]
    q, k, v = r(2, 5, 97, 96), r(2, 5, 97, 96), r(2, 5, 97, 96)
    assert _rel(frame_attention(q, k, v, 3),
                frame_attention_plain(q, k, v, 3, 32 ** -0.5)) <= TOL[dtype]
    # c 96: the tensor-core kernel in bf16; c 100: the CUDA-core one
    for c in (96, 100):
        x, inner = r(70, c), 4 * c
        args = (x, r(2 * inner, c, scale=0.1), r(2 * inner, scale=0.1),
                r(c, inner, scale=0.05), r(c, scale=0.1))
        assert _rel(geglu_ff(*args), geglu_ff_plain(*args)) <= TOL[dtype]
        args = (x, r(inner, c, scale=0.1), r(inner, scale=0.1),
                r(c, inner, scale=0.05), r(c, scale=0.1))
        assert _rel(gelu_ff(*args), gelu_ff_plain(*args)) <= TOL[dtype]
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"attention": 2, "frame_attention": 1,
                                   "geglu_ff": 2, "gelu_ff": 2}


@pytest.mark.gpu
def test_cuda_wrappers_raise_on_bad_operands(cuda):
    x = torch.zeros(2, 8, 16, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention(x, x, x, 2)
    y = torch.zeros(2, 16, 8, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError):
        flash_attention(y, y, y, 2)
    f = torch.zeros(4, 16, device=cuda)
    with pytest.raises(ValueError):  # w1 is (inner, c), not (c, inner)
        gelu_ff(f, torch.zeros(16, 64, device=cuda),
                torch.zeros(64, device=cuda), torch.zeros(16, 64, device=cuda),
                torch.zeros(16, device=cuda))
