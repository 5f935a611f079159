"""The port's distributed paths (``repro_torch.models.dist``, the sharded MoE
bodies of ``models/moe.py``, the sequence-sharded decode of
``models/attention.py`` and ``kernels.ops.decode_attention_partial``'s plain
version) against the JAX package, on gloo CPU ranks.

Every rank is a spawned process (``launch.mesh.run_ranks``, a ``FileStore``
in ``tmp_path``, a timeout of its own); the JAX side runs its 8-device mesh
in a subprocess with ``XLA_FLAGS`` set in that subprocess's environment
only, so the pytest process stays single-device and holds no process group.

  * the expert-parallel (E=8) and virtual-expert (E=2) bodies on JAX's own
    script configuration (``tests/test_distributed_paths.py``):
    mixtral-8x22b-smoke in fp32, top-2, x (4, 16, d), a (data 2, model 4)
    mesh, params carried across from JAX: out within 2e-4 and aux within
    1e-4 relative of JAX's sharded run, JAX's own bounds against the local
    path, no pair dropped;
  * the seq-sharded decode (JAX's sharded run raises under JAX 0.9.0) on
    a (1, 4) mesh against the port's replicated decode within 2e-3: the
    script's llava-next-mistral-7b-smoke (4 heads, 2 KV heads, B=2, 32
    slots from an empty cache), whose replicated run is held against
    JAX's mesh-free ``decode_step`` within 2e-3, a sliding window of 8 and
    a ring that wraps (16 slots over 32 steps);
  * the collectives each path counts, and ``layers.constrain`` on a DTensor.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import chip_smoke  # noqa: E402
import torch_dist_workers  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch.mesh import MeshShape, run_ranks  # noqa: E402
from repro_torch.models import dist, moe  # noqa: E402
from repro_torch.models.layers import constrain, use_logical_rules  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
MOE_TOL = 2e-4            # JAX's bound of its sharded MoE against its local path
AUX_JAX_RTOL = 1e-4       # the port's aux against JAX's sharded aux
AUX_LOCAL_RTOL = 5e-2     # a per-shard-mean estimator against the local aux
DECODE_TOL = 2e-3         # JAX's bound of its seq-sharded decode
SPAWN_TIMEOUT = 240
LLAVA = dict(arch="llava-next-mistral-7b", smoke=True, B=2, cache_len=32,
             length=0, steps=32, mesh=(1, 4), device="cpu", seed=0,
             overrides=dict(sliding_window=None, num_heads=4, num_kv_heads=2))

_JAX_SCRIPT = r"""
import sys, dataclasses
import numpy as np
import jax, jax.numpy as jnp
from repro.models import dist
from repro.models import transformer as T
from repro.models.moe import moe_init, moe_forward
from repro.configs import get_smoke_config

out_dir = sys.argv[1]
mesh = jax.make_mesh((2, 4), ("data", "model"))
ctx = dist.MeshContext(mesh=mesh, batch_axes=("data",), model_axis="model")
for E in (8, 2):
    cfg = dataclasses.replace(get_smoke_config("mixtral-8x22b"),
                              num_experts=E, num_experts_per_tok=2,
                              dtype="float32")
    key = jax.random.PRNGKey(0)
    p = moe_init(key, cfg, jnp.float32)
    x = jax.random.normal(jax.random.fold_in(key, 1), (4, 16, cfg.d_model))
    with dist.mesh_context(None):
        want, aux_want = moe_forward(p, cfg, x)
    with dist.mesh_context(ctx), dist.set_mesh(mesh):
        got, aux_got = jax.jit(lambda p_, x_: moe_forward(p_, cfg, x_))(p, x)
    np.savez(f"{out_dir}/moe{E}.npz", router_w=p["router"]["w"],
             w_gate=p["w_gate"], w_up=p["w_up"], w_down=p["w_down"], x=x,
             out=got, aux=aux_got, local_out=want, local_aux=aux_want)

# the seq-sharded script's decode, mesh-free (its sharded run raises)
cfg = dataclasses.replace(get_smoke_config("llava-next-mistral-7b"),
                          dtype="float32", sliding_window=None,
                          num_heads=4, num_kv_heads=2)
key = jax.random.PRNGKey(1)
params = T.init_params(key, cfg)
B, S = 2, 32
tokens = jax.random.randint(jax.random.fold_in(key, 2), (B, S), 0,
                            cfg.vocab_size)
state = T.init_decode_state(params, cfg, B, S)
step = jax.jit(lambda p, s, t: T.decode_step(p, cfg, s, t))
logits = []
for t in range(S):
    lg, state = step(params, state, tokens[:, t:t + 1])
    logits.append(np.asarray(lg))
flat, tree = jax.tree_util.tree_flatten_with_path(params)
np.savez(f"{out_dir}/decode.npz", tokens=np.asarray(tokens),
         logits=np.stack(logits),
         **{"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in flat})
print("JAX_OK")
"""


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """JAX's sharded MoE on a (2, 4) mesh of 8 forced host devices and its
    mesh-free decode, in a subprocess, as .npz files."""
    out = tmp_path_factory.mktemp("jax_dist")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    res = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(out)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert "JAX_OK" in res.stdout, res.stdout + res.stderr[-3000:]
    moe_runs = {E: dict(np.load(out / f"moe{E}.npz")) for E in (8, 2)}
    dec = dict(np.load(out / "decode.npz"))
    return moe_runs, dec


def _unflatten(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *keys, last = path.split("/")
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


@pytest.fixture(scope="module")
def port_moe(jax_runs, tmp_path_factory):
    """Both sharded bodies on 8 gloo ranks, a (2, 4) mesh, on JAX's params
    and x; rank 0 also runs the local path."""
    moe_runs, _ = jax_runs
    params = {E: {"p": {"router": {"w": r["router_w"]}, "w_gate": r["w_gate"],
                        "w_up": r["w_up"], "w_down": r["w_down"]},
                  "x": r["x"]} for E, r in moe_runs.items()}
    spec = dict(device="cpu", mesh=(2, 4), experts=(8, 2), smoke=True,
                params=params)
    return run_ranks(chip_smoke.dist_moe_rank, 8, device="cpu", args=(spec,),
                     timeout_s=SPAWN_TIMEOUT,
                     workdir=str(tmp_path_factory.mktemp("ranks")))


def _decode_specs(dec):
    base = dict(LLAVA, params=_unflatten({k: v for k, v in dec.items()
                                          if k not in ("tokens", "logits")}),
                tokens=dec["tokens"].T[:, :, None].copy(),
                layers=get_smoke_config("llava-next-mistral-7b").num_layers)
    window = dict(LLAVA, layers=base["layers"],
                  overrides=dict(LLAVA["overrides"], sliding_window=8))
    wrap = dict(LLAVA, layers=base["layers"], cache_len=16)
    return {"script": base, "window8": window, "wrap16": wrap}


@pytest.fixture(scope="module")
def port_decode(jax_runs, tmp_path_factory):
    """The three decode cases and the DTensor check on 4 gloo ranks."""
    specs = _decode_specs(jax_runs[1])
    res = run_ranks(torch_dist_workers.decode_cases, 4, device="cpu",
                    args=(list(specs.values()),), timeout_s=SPAWN_TIMEOUT,
                    workdir=str(tmp_path_factory.mktemp("ranks")))
    cases = {name: [r[0][i] for r in res] for i, name in enumerate(specs)}
    return specs, cases, [r[1] for r in res]


# ---------------------------------------------------------------------------
# sharded MoE
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("E", [8, 2], ids=["expert-parallel", "virtual-expert"])
def test_sharded_moe_matches_jax_sharded_run(jax_runs, port_moe, E):
    want = jax_runs[0][E]
    for r in port_moe:
        rec = r[E]
        lo, hi = rec["batch_rows"]
        np.testing.assert_allclose(rec["out"].numpy(), want["out"][lo:hi],
                                   rtol=MOE_TOL, atol=MOE_TOL)
        assert abs(rec["aux"] - float(want["aux"])) <= \
            AUX_JAX_RTOL * abs(float(want["aux"]))
        assert rec["dropped"] == 0 and rec["readbacks"] == 1


@pytest.mark.parametrize("E", [8, 2], ids=["expert-parallel", "virtual-expert"])
def test_sharded_moe_holds_jax_bounds_against_the_local_path(jax_runs, port_moe,
                                                            E):
    """JAX's own bounds (2e-4 on out, 5% on aux), and the port's local path
    against JAX's local path."""
    chip_smoke.check_moe_ranks(port_moe, "test", tol=MOE_TOL,
                               aux_rtol=AUX_LOCAL_RTOL)
    local = port_moe[0][E]
    np.testing.assert_allclose(local["local_out"].numpy(),
                               jax_runs[0][E]["local_out"], rtol=1e-5,
                               atol=1e-5)


def test_sharded_moe_counts_its_collectives(port_moe):
    """A psum of the (T_loc, d) output and a pmean of the scalar aux a call."""
    cfg = get_smoke_config("mixtral-8x22b")
    T_loc = 2 * 16                       # 2 rows of 16 tokens a data shard
    for E in (8, 2):
        c = port_moe[0][E]["collectives"]
        assert c["psum"] == {"count": 1, "bytes": T_loc * cfg.d_model * 4}
        assert c["pmean"] == {"count": 1, "bytes": 4}
        assert c["pmax"] == {"count": 0, "bytes": 0}


def test_sharded_bodies_refuse_a_gradient():
    """Forward only: a body on tensors that require grad raises, naming the
    ROADMAP item.  No rank is needed: the check comes before any
    collective."""
    shape = MeshShape(("data", "model"), (1, 4))
    for E in (8, 2):
        cfg = dataclasses.replace(get_smoke_config("mixtral-8x22b"),
                                  num_experts=E, dtype="float32")
        p = moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32)
        x = torch.zeros((1, 4, cfg.d_model), requires_grad=True)
        with dist.mesh_context(dist.MeshContext(shape, ("data",), "model")):
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                moe.moe_forward(p, cfg, x)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kept_rows_sum_in_the_order_of_jaxs_scatter(dtype):
    """A sharded body's kept rows, 0 to k a token, sorted by expert: each
    token sums its rows in turn, rounding after each add, as JAX's
    ``.at[tok_s].add`` does; a token with none gets zeros."""
    T_, E, k, d = 24, 8, 3, 16
    rng = np.random.default_rng(5)
    eids = np.stack([rng.choice(E, k, replace=False) for _ in range(T_)])
    kept = rng.random((T_, k)) < 0.6
    kept[:3] = False                        # tokens with no local pair
    tok = np.repeat(np.arange(T_), k)[kept.reshape(-1)]
    e = eids.reshape(-1)[kept.reshape(-1)]
    tok_s = torch.from_numpy(tok[np.argsort(e, kind="stable")])
    rows = torch.from_numpy(rng.normal(size=(len(tok), d)) * np.exp2(
        rng.integers(-4, 5, (len(tok), 1)))).to(dtype)
    want = torch.zeros((T_, d), dtype=dtype)
    for r, t in enumerate(tok_s.tolist()):
        want[t] = want[t] + rows[r]
    got = moe._combine_kept(rows, tok_s, T_, k)
    assert got.dtype == dtype
    assert torch.equal(got, want)


def test_sharded_bodies_take_only_the_ranks_own_stacks():
    """Under a context a body takes this rank's stacks, as
    ``shard_params`` gives them, and refuses the whole ones."""
    shape = MeshShape(("data", "model"), (1, 4))
    for E in (8, 2):
        cfg = dataclasses.replace(get_smoke_config("mixtral-8x22b"),
                                  num_experts=E, dtype="float32")
        p = moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32)
        x = torch.zeros((1, 4, cfg.d_model))
        with dist.mesh_context(dist.MeshContext(shape, ("data",), "model")):
            with pytest.raises(ValueError, match="shard_params"):
                moe.moe_forward(p, cfg, x)


# ---------------------------------------------------------------------------
# seq-sharded decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["script", "window8", "wrap16"])
def test_seq_sharded_decode_matches_the_replicated_decode(port_decode, case):
    specs, cases, _ = port_decode
    spec, res = specs[case], cases[case]
    err = chip_smoke.check_decode_ranks(res, spec, tol=DECODE_TOL)
    S = spec["cache_len"] if case != "window8" else 8
    assert [r["shard"] for r in res] == [(m * S // 4, S) for m in range(4)]
    assert all(r["slots"] == S // 4 for r in res)
    assert err <= DECODE_TOL


def test_replicated_decode_matches_jax_mesh_free(jax_runs, port_decode):
    _, cases, _ = port_decode
    np.testing.assert_allclose(cases["script"][0]["replicated_logits"].numpy(),
                               jax_runs[1]["logits"], rtol=DECODE_TOL,
                               atol=DECODE_TOL)


def test_seq_sharded_decode_counts_its_collectives(port_decode):
    """Per layer and step a pmax of (b, KV, g) and psums of (b, KV, g) and
    (b, KV, g, hd), fp32."""
    specs, cases, _ = port_decode
    spec = specs["script"]
    cfg = chip_smoke.dist_decode_config(spec)
    KV, g = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
    n = spec["steps"] * spec["layers"]
    stat = spec["B"] * KV * g * 4
    for r in cases["script"]:
        c = r["collectives"]
        assert c["pmax"] == {"count": n, "bytes": n * stat}
        assert c["psum"] == {"count": 2 * n, "bytes": n * stat * (
            1 + cfg.resolved_head_dim)}
        assert c["pmean"]["count"] == 0


def test_psum_reduces_bf16_in_its_dtype(port_decode):
    """gloo all-reduces a bf16 tensor as it is: the sum comes back bf16,
    exact where bf16 holds it."""
    _, cases, _ = port_decode
    for r in cases["script"]:
        assert r["psum_bf16"] == {"dtype": "torch.bfloat16", "exact": True}


def test_constrain_redistributes_a_dtensor_and_passes_a_tensor(port_decode):
    *_, checks = port_decode
    for m, c in enumerate(checks):
        assert c["placements"] == ["S(0)", "S(1)"] or \
            c["placements"] == ["Shard(dim=0)", "Shard(dim=1)"]
        x = torch.arange(32.0).reshape(4, 8)
        assert torch.equal(c["local"], x[:, 2 * m:2 * m + 2])
        assert torch.equal(c["full"], x) and c["plain_unchanged"]
    y = torch.ones(2, 3)
    with use_logical_rules({"batch": "data"}):
        assert constrain(y, "batch", None) is y
    assert constrain(y, "batch", None) is y


# ---------------------------------------------------------------------------
# decode_attention_partial's plain version
# ---------------------------------------------------------------------------
def _partial_inputs(B=2, S=40, H=6, KV=2, hd=16, seed=3):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((B, 1, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    return q, k, v


def _fp64_partial(q, k, v, valid, scale):
    B, _, H, hd = q.shape
    KV = k.shape[2]
    qg = q.double().reshape(B, KV, H // KV, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg, k.double()) * scale
    if not valid.any():
        return (torch.full(s.shape[:3], -1e30, dtype=torch.float64),
                torch.zeros(s.shape[:3], dtype=torch.float64),
                torch.zeros((*s.shape[:3], hd), dtype=torch.float64))
    s = s[..., valid]
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    return m, p.sum(-1), torch.einsum("bkgs,bskh->bkgh", p,
                                      v.double()[:, valid])


@pytest.mark.parametrize("mask", ["all", "ring", "none"])
def test_partial_plain_matches_fp64(mask):
    q, k, v = _partial_inputs()
    S = k.shape[1]
    valid = {"all": torch.ones(S, dtype=torch.bool),
             "ring": torch.arange(S) % 7 < 3,
             "none": torch.zeros(S, dtype=torch.bool)}[mask]
    got = ref.decode_attention_partial(q, k, v, valid, scale=0.25)
    want = _fp64_partial(q, k, v, valid, 0.25)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-6)
    if mask == "none":
        assert bool((got[0] == -1e30).all()) and not got[1].any() \
            and not got[2].any()


def test_partials_of_four_slices_recombine_to_decode_attention():
    """The combine of ``attention.combine_partials`` over 4 slices (one
    with no valid slot) is ``ref.decode_attention`` of the whole cache."""
    q, k, v = _partial_inputs(S=64)
    valid = torch.zeros(64, dtype=torch.bool)
    valid[20:45] = True                         # slice 0 holds none
    parts = [ref.decode_attention_partial(q, k[:, i:i + 16], v[:, i:i + 16],
                                          valid[i:i + 16], scale=0.25)
             for i in range(0, 64, 16)]
    m = torch.stack([p[0] for p in parts]).amax(0)
    a = [torch.exp(p[0] - m) for p in parts]
    l = sum(x * p[1] for x, p in zip(a, parts))
    o = sum(x[..., None] * p[2] for x, p in zip(a, parts))
    got = (o / torch.clamp_min(l, 1e-30)[..., None]).reshape(q.shape)
    want = ref.decode_attention(q, k, v, valid, scale=0.25)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


def test_partial_wrapper_takes_the_plain_version_on_the_cpu():
    q, k, v = _partial_inputs()
    valid = torch.arange(k.shape[1]) < 30
    ops.reset_launches()
    got = ops.decode_attention_partial(q, k, v, valid, scale=0.5)
    want = ref.decode_attention_partial(q, k, v, valid, scale=0.5)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ops.launches["decode_attention_partial"] == 0
    with pytest.raises(ValueError, match="validity"):
        ops.decode_attention_partial(q, k, v, valid[:5], scale=0.5)
