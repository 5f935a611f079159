"""TF32 tensor-core products emulated on the CPU, for the tests that hold
the port's 3xTF32 kernels' arithmetic to its tolerances
(``test_torch_ssm.py``: the scan's forward, ``test_torch_scan_grad.py``:
its backward)."""
import torch


def tf32(x):
    """x rounded as a tensor core takes an fp32 operand in TF32 (cvt.rna):
    to nearest, ties away from zero, 10 mantissa bits, on the int32 view."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(x):
    """x's TF32 bits as a tensor core reads them: the 13 low bits dropped."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def tf32_matmul(a, b, split):
    """a @ b with TF32 operands: one product (split=1) or the 3xTF32 split
    hi·hi + hi·lo + lo·hi, hi = tf32(a), lo = a - hi read as TF32; fp32
    sums."""
    ah, bh = tf32(a), tf32(b)
    if split == 1:
        return ah @ bh
    al, bl = tf32_trunc(a - ah), tf32_trunc(b - bh)
    return al @ bh + ah @ bl + ah @ bh
