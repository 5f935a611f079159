"""The port's xLSTM path (``repro_torch.models.xlstm`` and xlstm-125m's
hybrid stack in ``models/transformer.py``) against the JAX package: the
same numpy inputs, JAX params carried across with ``params_from_jax``.

Tolerances (ROADMAP.md's standing decisions): fp32 within 1e-4 (rtol and
atol) of JAX, the time loop in another order of operations than
``lax.scan``'s fused steps; a bf16 forward's error against the fp32
forward of the same params at most 1.25× the JAX package's own, in max and
mean."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.models import transformer as JT
from repro.models import xlstm as jxl
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import MLSTM
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve, train
from repro_torch.models import transformer as T
from repro_torch.models import xlstm
from repro_torch.tree import tree_leaves

ARCH = "xlstm-125m"
TOL32 = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small CPU ops (one step of the time loop each): under
    pytest-xdist torch's intra-op pool only oversubscribes the cores, so
    the module runs on one thread and restores the count after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _cfgs(dtype="float32"):
    return (dataclasses.replace(jget_smoke(ARCH), dtype=dtype),
            dataclasses.replace(get_smoke_config(ARCH), dtype=dtype))


def _params(jcfg, seed=0):
    jp = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _tokens(vocab, B=2, S=32, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def _block(kind, jcfg, seed):
    init = jxl.mlstm_init if kind == "mlstm" else jxl.slstm_init
    jp = init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


JAX_BLOCK = {"mlstm": (jxl.mlstm_forward, jxl.mlstm_init_cache, jxl.mlstm_decode),
             "slstm": (jxl.slstm_forward, jxl.slstm_init_cache, jxl.slstm_decode)}
PORT_BLOCK = {"mlstm": (xlstm.mlstm_forward, xlstm.mlstm_init_cache,
                        xlstm.mlstm_decode),
              "slstm": (xlstm.slstm_forward, xlstm.slstm_init_cache,
                        xlstm.slstm_decode)}


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
def test_xlstm_configs_are_the_jax_configs():
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jget_config(ARCH))
    assert dataclasses.asdict(get_smoke_config(ARCH)) == \
        dataclasses.asdict(jget_smoke(ARCH))
    assert get_config(ARCH).param_count() == \
        jget_config(ARCH).param_count() == 109_412_352


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_forward_matches_jax(kind):
    """A block's forward over S=32 from the zero state, fp32."""
    jcfg, cfg = _cfgs()
    jp, tp = _block(kind, jcfg, seed=1)
    x = np.random.default_rng(1).normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    want = JAX_BLOCK[kind][0](jp, jcfg, jnp.asarray(x))
    got = PORT_BLOCK[kind][0](tp, cfg, torch.from_numpy(x))
    assert got.shape == (2, 32, cfg.d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **TOL32)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_decode_matches_jax(kind):
    """32 one-token steps from the initial cache: every step's output and
    the final cache's tensors within 1e-4 of JAX's, and the steps agree
    with the block's own forward over the same 32 tokens."""
    jcfg, cfg = _cfgs()
    jp, tp = _block(kind, jcfg, seed=2)
    x = np.random.default_rng(2).normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    jfwd, jinit, jdec = JAX_BLOCK[kind]
    tfwd, tinit, tdec = PORT_BLOCK[kind]
    jc, tc = jinit(jcfg, 2), tinit(cfg, 2, "cpu")
    step = jax.jit(lambda p, xt, c: jdec(p, jcfg, xt, c))
    outs = []
    for t in range(32):
        jy, jc = step(jp, jnp.asarray(x[:, t:t + 1]), jc)
        ty, tc = tdec(tp, cfg, torch.from_numpy(x[:, t:t + 1]), tc)
        np.testing.assert_allclose(_np(ty), _np(jy), err_msg=f"t={t}", **TOL32)
        outs.append(_np(ty))
    assert tc.length == int(jc.length) == 32
    for a, b in zip(tc[:-1], jc[:-1]):
        np.testing.assert_allclose(_np(a), _np(b), **TOL32)
    np.testing.assert_allclose(np.concatenate(outs, 1),
                               _np(tfwd(tp, cfg, torch.from_numpy(x))), **TOL32)


# ---------------------------------------------------------------------------
# the xlstm-125m-smoke stack
# ---------------------------------------------------------------------------
def test_params_and_decode_state_follow_the_jax_tree():
    """The port's own init has the JAX tree's leaf shapes and dtypes (w_if
    in fp32 under a bf16 model) in the JAX leaf order, and a JAX decode
    state carries across cache by cache."""
    jcfg, cfg = _cfgs("bfloat16")
    jshapes = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0), jcfg))
    tp = T.init_params(cfg, seed=1, device="cpu")
    assert [(tuple(a.shape), str(a.dtype)) for a in jax.tree.leaves(jshapes)] \
        == [(tuple(t.shape), str(t.dtype)[6:]) for t in tree_leaves(tp)]
    jp, _ = _params(jcfg)
    js = JT.init_decode_state(jp, jcfg, 2, 16)
    ts = T.init_decode_state(tp, cfg, 2, 16)
    cs = params_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    for i, kind in enumerate(cfg.layer_kinds()):
        mine, theirs = ts["blocks"][str(i)], cs["blocks"][str(i)]
        assert type(mine) is type(theirs) is (
            xlstm.MLSTMCache if kind == MLSTM else xlstm.SLSTMCache)
        assert mine.length == theirs.length == 0
        for a, b in zip(mine[:-1], theirs[:-1]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hidden_states_and_forward_match_jax(dtype):
    jcfg, cfg = _cfgs(dtype)
    jp, tp = _params(jcfg)
    toks = _tokens(cfg.vocab_size)
    labels = np.roll(toks, -1, 1)
    labels[0, :3] = -1
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks).long(),
          "labels": torch.from_numpy(labels).long()}
    jh, _ = JT.hidden_states(jp, jcfg, jb)
    th, aux = T.hidden_states(tp, cfg, tb)
    assert th.dtype == T.torch_dtype(cfg) and float(aux) == 0.0
    jl, jm = JT.forward(jp, jcfg, jb, loss_chunk=16)
    tl, tm = T.forward(tp, cfg, tb, loss_chunk=16)
    assert float(tm["target_tokens"]) == float(jm["target_tokens"]) == 61.0
    if dtype == "float32":
        np.testing.assert_allclose(_np(th), _np(jh), **TOL32)
        np.testing.assert_allclose(float(tl), float(jl), **TOL32)
        return
    # bf16: XLA and eager PyTorch round at different points, so the port
    # is held to the fp32 forward of the same params: its error no larger
    # than 1.25x the JAX package's own bf16 error
    j32cfg, _ = _cfgs("float32")
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    j32, _ = JT.hidden_states(jp32, j32cfg, jb)
    err_port = np.abs(_np(th) - _np(j32))
    err_jax = np.abs(_np(jh) - _np(j32))
    assert err_port.max() <= 1.25 * err_jax.max(), (err_port.max(), err_jax.max())
    assert err_port.mean() <= 1.25 * err_jax.mean(), (err_port.mean(), err_jax.mean())
    jl32, _ = JT.forward(jp32, j32cfg, jb, loss_chunk=16)
    assert abs(float(tl) - float(jl32)) <= 1.25 * abs(float(jl) - float(jl32)) + 1e-3


def test_decode_step_matches_jax_and_continues_from_a_jax_state():
    """10 decode steps of the stack against JAX's, logits within 1e-4; then
    a JAX state carried across decodes the next 4 steps as JAX does."""
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg, seed=4)
    toks = _tokens(cfg.vocab_size, S=14, seed=4)
    js = JT.init_decode_state(jp, jcfg, 2, 8)
    ts = T.init_decode_state(tp, cfg, 2, 8)
    step = jax.jit(lambda p, s, t: JT.decode_step(p, jcfg, s, t))
    for t in range(10):
        jlog, js = step(jp, js, jnp.asarray(toks[:, t:t + 1]))
        tlog, ts = T.decode_step(tp, cfg, ts, torch.from_numpy(toks[:, t:t + 1]).long())
        assert tlog.dtype == torch.float32 and tlog.shape == (2, cfg.vocab_size)
        np.testing.assert_allclose(_np(tlog), _np(jlog), err_msg=f"t={t}", **TOL32)
    cs = params_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    for t in range(10, 14):
        jlog, js = step(jp, js, jnp.asarray(toks[:, t:t + 1]))
        clog, cs = T.decode_step(tp, cfg, cs, torch.from_numpy(toks[:, t:t + 1]).long())
        np.testing.assert_allclose(_np(clog), _np(jlog), err_msg=f"t={t}", **TOL32)
    assert all(c.length == 14 for c in cs["blocks"].values())


@pytest.mark.parametrize("remat", [True, False])
def test_value_and_grad_matches_jax(remat):
    """``launch.train.value_and_grad``'s loss and every leaf of its
    gradient against ``jax.value_and_grad`` of the JAX forward, fp32."""
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg, seed=5)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    labels[0, :3] = -1
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    jloss, jgrads = jax.value_and_grad(
        lambda p: JT.forward(p, jcfg, jbatch, loss_chunk=16, remat=remat)[0])(jp)
    loss, grads = train.value_and_grad(cfg, tp, torch.from_numpy(toks),
                                       torch.from_numpy(labels), loss_chunk=16,
                                       remat=remat)
    assert abs(float(loss) - float(jloss)) <= 1e-5
    g, w = tree_leaves(grads), jax.tree.leaves(jgrads)
    assert len(g) == len(w) == 17
    for a, b in zip(g, w):
        np.testing.assert_allclose(_np(a), _np(b), **TOL32)


def test_serve_generates_the_jax_greedy_tokens():
    """``launch/serve.generate`` on xlstm-125m-smoke: a 6-token prompt
    teacher-forced through ``decode_step``, then 5 greedy tokens, the JAX
    decode loop's."""
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg, seed=3)
    prompts = _tokens(cfg.vocab_size, S=6, seed=3)
    res = serve.generate(tp, cfg, torch.from_numpy(prompts).long(), 5, 16)
    js = JT.init_decode_state(jp, jcfg, 2, 16)
    step = jax.jit(lambda p, s, t: JT.decode_step(p, jcfg, s, t))
    for t in range(prompts.shape[1]):
        logits, js = step(jp, js, jnp.asarray(prompts[:, t:t + 1]))
    out = []
    for _ in range(6):
        tok = jnp.argmax(logits, -1)[:, None]
        out.append(np.asarray(tok))
        logits, js = step(jp, js, tok)
    np.testing.assert_array_equal(res["tokens"].numpy(), np.concatenate(out, 1))


def test_the_train_entry_point_defaults_to_xlstm():
    """``python -m repro_torch.launch.train`` trains xlstm-125m by default,
    as the JAX package's ``launch/train.py`` does."""
    r = train.main(["--device", "cpu", "--smoke-scale=true", "--steps", "3",
                    "--batch", "2", "--seq", "16", "--lr", "3e-2"])
    assert r["cfg"].name == "xlstm-125m-smoke"
    assert np.all(np.isfinite(r["losses"]))
