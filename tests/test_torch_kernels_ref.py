"""The port's aggregation kernels (``repro_torch.kernels``) against the JAX
package: the plain PyTorch versions against ``repro.kernels.ref`` and the
Pallas kernels in interpret mode, the device dispatch and launch counters,
and the rule that the port imports no JAX.  The CUDA kernels against their
plain versions on the card are in ``test_torch_kernels_gpu.py``."""
import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.dequant_agg import dequant_fedagg as pallas_dequant_fedagg
from repro.kernels.dequant_agg import float_fedagg as pallas_float_fedagg
from repro.kernels.fedagg import fedagg as pallas_fedagg
from repro_torch.kernels import ops, ref
from repro_torch.tree import tree_flatten, tree_unflatten

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPES = [(3, 100), (22, 4096), (7, 13000), (1, 257)]     # tests/test_kernels.py


def _inputs(m, p, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, p)).astype(np.float32)
    q = rng.integers(-127, 128, size=(m, p)).astype(np.int8)
    w = rng.uniform(0.1, 1.0, m)
    betas = (w / w.sum()).astype(np.float32)
    scales = rng.uniform(1e-3, 1e-2, m).astype(np.float32)
    return x, q, betas, scales


def _tol(out_dtype):
    return dict(rtol=2e-2, atol=2e-2) if out_dtype == "bf16" else \
        dict(rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# (a) plain versions against the JAX reference and the Pallas kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,p", SHAPES)
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_fedagg_plain_matches_jax(m, p, dtype):
    x, _, betas, _ = _inputs(m, p, seed=m * 7 + p)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "fp32"
                else (jnp.bfloat16, torch.bfloat16))
    jx = jnp.asarray(x).astype(jdt)
    tx = torch.from_numpy(x).to(tdt)
    got = ref.fedagg(tx, torch.from_numpy(betas))
    assert got.dtype == tdt and got.shape == (p,)
    got = got.float().numpy()
    want_ref = np.asarray(jref.fedagg(jx, jnp.asarray(betas)), np.float32)
    want_pallas = np.asarray(pallas_fedagg(jx, jnp.asarray(betas), block=512,
                                           interpret=True), np.float32)
    np.testing.assert_allclose(got, want_ref, **_tol(dtype))
    np.testing.assert_allclose(got, want_pallas, **_tol(dtype))


@pytest.mark.parametrize("m,p", SHAPES)
@pytest.mark.parametrize("dtype", ["fp32", "fp16"])
def test_float_fedagg_plain_matches_jax(m, p, dtype):
    x, _, betas, _ = _inputs(m, p, seed=m * 11 + p)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "fp32"
                else (jnp.float16, torch.float16))
    jx = jnp.asarray(x).astype(jdt)
    got = ref.float_fedagg(torch.from_numpy(x).to(tdt), torch.from_numpy(betas))
    assert got.dtype == torch.float32
    want_ref = np.asarray(jref.float_fedagg(jx, jnp.asarray(betas)))
    want_pallas = np.asarray(pallas_float_fedagg(jx, jnp.asarray(betas),
                                                 block=256, interpret=True))
    np.testing.assert_allclose(got.numpy(), want_ref, **_tol("fp32"))
    np.testing.assert_allclose(got.numpy(), want_pallas, **_tol("fp32"))


@pytest.mark.parametrize("m,p", SHAPES)
def test_dequant_fedagg_plain_matches_jax(m, p):
    _, q, betas, scales = _inputs(m, p, seed=m * 13 + p)
    got = ref.dequant_fedagg(torch.from_numpy(q), torch.from_numpy(scales),
                             torch.from_numpy(betas))
    assert got.dtype == torch.float32
    args = (jnp.asarray(q), jnp.asarray(scales), jnp.asarray(betas))
    want_ref = np.asarray(jref.dequant_fedagg(*args))
    want_pallas = np.asarray(pallas_dequant_fedagg(*args, block=256,
                                                   interpret=True))
    np.testing.assert_allclose(got.numpy(), want_ref, **_tol("fp32"))
    np.testing.assert_allclose(got.numpy(), want_pallas, **_tol("fp32"))


def test_plain_fold_is_the_reference_flush_order():
    """The fold is the JAX package's "off" flush, term by term."""
    x, q, betas, scales = _inputs(5, 333, seed=3)
    want = None
    for m in range(5):
        term = (np.float32(betas[m]) * np.float32(scales[m])) * q[m].astype(np.float32)
        want = term if want is None else want + term
    got = ref.dequant_fedagg(torch.from_numpy(q), torch.from_numpy(scales),
                             torch.from_numpy(betas))
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        ref.float_fedagg(torch.zeros((0, 4)), torch.zeros((0,)))


# ---------------------------------------------------------------------------
# dispatch: by device, no fallback, counters only for kernel launches
# ---------------------------------------------------------------------------
def test_cpu_tensors_take_the_plain_versions_uncounted():
    x, q, betas, scales = _inputs(4, 1000, seed=5)
    tx, tq = torch.from_numpy(x), torch.from_numpy(q)
    tb, ts = torch.from_numpy(betas), torch.from_numpy(scales)
    ops.reset_launches()
    assert torch.equal(ops.float_fedagg(tx, tb), ref.float_fedagg(tx, tb))
    assert torch.equal(ops.fedagg(tx, tb), ref.fedagg(tx, tb))
    assert torch.equal(ops.dequant_fedagg(tq, ts, tb),
                       ref.dequant_fedagg(tq, ts, tb))
    rng = np.random.default_rng(6)
    xl, w, a, b = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                   for s in ((5, 16), (16, 12), (16, 4), (4, 12)))
    assert torch.equal(ops.lora_matmul(xl, w, a, b, 2.0),
                       ref.lora_matmul(xl, w, a, b, 2.0))
    xdt, a_log, bm, cm = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                          for s in ((2, 12, 3, 4), (2, 12, 3), (2, 12, 5), (2, 12, 5)))
    assert torch.equal(ops.selective_scan(xdt, a_log, bm, cm, chunk=4),
                       ref.ssd_chunked(xdt, a_log, bm, cm,
                                       torch.zeros((2, 3, 4, 5)), 4)[0])
    assert all(torch.equal(g, w) for g, w in zip(
        ops.selective_scan_bwd(xdt, a_log, bm, cm, xdt, None, chunk=4),
        ref.selective_scan_bwd(xdt, a_log, bm, cm, xdt, chunk=4)))
    idx = torch.tensor([[0, 3, 7], [1, 3, 9]], dtype=torch.int32)
    vals = torch.from_numpy(rng.normal(size=(2, 3)).astype(np.float32))
    assert torch.equal(ops.topk_fedagg(idx, vals, tb[:2], 10),
                       ref.topk_fedagg(idx, vals, tb[:2], 10))
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((2, 1, 4, 8), (2, 6, 2, 8), (2, 6, 2, 8)))
    valid = torch.arange(6) < 4
    assert all(torch.equal(g, w) for g, w in zip(
        ops.decode_attention_partial(q, k, v, valid, scale=0.5),
        ref.decode_attention_partial(q, k, v, valid, scale=0.5)))
    assert ops.launches == {"float_fedagg": 0, "dequant_fedagg": 0, "fedagg": 0,
                            "flash_attention": 0, "flash_attention_bwd": 0,
                            "decode_attention": 0,
                            "decode_attention_partial": 0, "lora_matmul": 0,
                            "selective_scan": 0, "selective_scan_bwd": 0,
                            "topk_fedagg": 0}


def test_wrappers_refuse_devices_without_a_kernel():
    x = torch.empty((3, 10), device="meta")
    b = torch.empty((3,), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.float_fedagg(x, b)
    with pytest.raises(ValueError, match="different devices"):
        ops.fedagg(torch.zeros((3, 10)), b)


def test_kernel_wrappers_have_no_fallback_path():
    """No ``try``/``except`` anywhere in the kernel package: a build or
    launch error is never swallowed."""
    for path in (ROOT / "src" / "repro_torch" / "kernels").rglob("*.py"):
        tree = ast.parse(path.read_text())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), path


# ---------------------------------------------------------------------------
# (e) the port imports no JAX and nothing of the JAX package
# ---------------------------------------------------------------------------
def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_port_imports_no_jax_and_no_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    assert {"moe.py", "attention.py", "mixtral_8x22b.py", "deepseek_v2_236b.py",
            "seamless_m4t_large_v2.py", "llava_next_mistral_7b.py"} <= \
        {p.name for p in files}
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax", "optax"), \
                f"{path.relative_to(ROOT)} imports {mod}"


def test_tree_flatten_follows_jax_sorted_key_order():
    tree = {"b": {"z": 1, "a": 2}, "a": 3, "c": {"y": {"k": 4}, "x": 5}}
    leaves, spec = tree_flatten(tree)
    assert leaves == jax.tree.leaves(tree)
    assert tree_unflatten(spec, leaves) == tree
