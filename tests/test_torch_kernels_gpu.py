"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``gpu``: each test skips with a reason where there is no CUDA device.
The file imports no JAX, so it also runs on a machine that has only the
port's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

SHAPES = [(3, 100), (22, 4096), (7, 13000), (1, 257), (64, 2_359_296),
          (22, 11_223_140)]


def _inputs(case, m, p, seed, device):
    """(x, scales, betas) drawn on the card: x in the case's dtype."""
    g = torch.Generator(device=device).manual_seed(seed)
    if case == "dequant_int8":
        x = torch.randint(-127, 128, (m, p), generator=g, device=device,
                          dtype=torch.int8)
    else:
        dt = {"fp32": torch.float32, "fp16": torch.float16,
              "bf16": torch.bfloat16}[case.split("_")[1]]
        x = torch.randn((m, p), generator=g, device=device).to(dt)
    w = torch.rand((m,), generator=g, device=device) + 0.1
    scales = torch.rand((m,), generator=g, device=device) * 9e-3 + 1e-3
    return x, scales, w / w.sum()


# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run with -m gpu on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("m,p", SHAPES)
@pytest.mark.parametrize("case", ["float_fp32", "float_fp16", "dequant_int8",
                                  "fedagg_fp32", "fedagg_bf16"])
def test_cuda_kernel_matches_plain_version(cuda_device, case, m, p):
    x, s, b = _inputs(case, m, p, seed=m + p, device=cuda_device)
    key = {"float": "float_fedagg", "dequant": "dequant_fedagg",
           "fedagg": "fedagg"}[case.split("_")[0]]
    before = dict(ops.launches)
    if key == "dequant_fedagg":
        got, want = ops.dequant_fedagg(x, s, b), ref.dequant_fedagg(x, s, b)
    else:
        got, want = getattr(ops, key)(x, b), getattr(ref, key)(x, b)
    torch.cuda.synchronize()
    assert ops.launches[key] == before[key] + 1
    assert got.dtype == want.dtype and got.device.type == "cuda"
    assert got.shape == (p,)
    # fp32 out: fold vs FMA chain; bf16 out: one bf16 rounding of the sum
    tol = (dict(rtol=2e-2, atol=2e-2) if case.endswith("bf16")
           else dict(rtol=1e-5, atol=1e-6))
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol)


@pytest.mark.gpu
def test_wrappers_refuse_what_the_kernel_does_not_take(cuda_device):
    x = torch.zeros((3, 8), device=cuda_device)
    b = torch.full((3,), 1 / 3, device=cuda_device)
    with pytest.raises(TypeError):
        ops.fedagg(x.to(torch.float16), b)
    with pytest.raises(ValueError, match="contiguous"):
        ops.float_fedagg(torch.zeros((8, 3), device=cuda_device).t(), b)
    with pytest.raises(ValueError, match="coefficient"):
        ops.float_fedagg(x, b[:2])
    with pytest.raises(ValueError, match="different devices"):
        ops.float_fedagg(x, b.cpu())
