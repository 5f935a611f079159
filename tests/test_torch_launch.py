"""The port's launch layer (``repro_torch.launch``: ``mesh``, ``sharding``,
``roofline``, ``dryrun``) against the JAX package's.

The partition rules are compared leaf for leaf under ``convert``'s leaf
names, with JAX's ``param_pspecs`` on an ``AbstractMesh`` (no devices) and
the port's on meta-device params, for every arch of the zoo on both
production meshes.  JAX's ``decode_state_pspecs`` lives in its dry-run
module, which sets ``XLA_FLAGS`` when imported, so it runs in a subprocess
that writes its specs as JSON; the pytest process sets no environment.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import list_archs
from repro.launch import roofline as jrl
from repro.launch import sharding as jsh
from repro.models import transformer as JT
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import dryrun, mesh as lm, roofline, sharding
from repro_torch.models import moe
from repro_torch.models import transformer as T

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_workers  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
DECODE_SHAPES = ("decode_32k", "long_500k")

_JAX_SCRIPT = r"""
import json, sys
import jax
from repro.configs import get_config
from repro.launch import dryrun as D
from repro.launch.sharding import INPUT_SHAPES

def abstract(shape, names):
    try:
        return jax.sharding.AbstractMesh(shape, names)
    except TypeError:
        return jax.sharding.AbstractMesh(tuple(zip(names, shape)))

def flat(node, path, out):
    if isinstance(node, dict):
        for k in node:
            flat(node[k], f"{path}/{k}", out)
    elif isinstance(node, tuple) and hasattr(node, "_fields"):
        for f in node._fields:
            flat(getattr(node, f), f"{path}/{f}", out)
    else:
        out[path] = [list(a) if isinstance(a, tuple) else a for a in node]

meshes = json.loads(sys.argv[2])
res = {}
for arch in D.ASSIGNED:
    cfg = get_config(arch)
    for mname, (shape, names) in meshes.items():
        mesh = abstract(tuple(shape), tuple(names))
        for s in ("decode_32k", "long_500k"):
            sh = INPUT_SHAPES[s]
            clen = D.cache_len_for(cfg, sh["seq_len"])
            out = {}
            flat(D.decode_state_pspecs(cfg, mesh, sh["global_batch"], clen),
                 "", out)
            res[f"{arch}|{mname}|{s}"] = out
json.dump(res, open(sys.argv[1], "w"))
print("JAX_OK")
"""


def _abstract_mesh(shape, names):
    try:
        return jax.sharding.AbstractMesh(shape, names)
    except TypeError:
        return jax.sharding.AbstractMesh(tuple(zip(names, shape)))


def _tup(spec):
    return tuple(tuple(a) if isinstance(a, list) else a for a in spec)


def _flat_port(node, path="", out=None):
    """path -> spec of a port spec tree (caches by the JAX caches' fields)."""
    out = {} if out is None else out
    if isinstance(node, dict):
        for k in node:
            _flat_port(node[k], f"{path}/{k}", out)
    elif isinstance(node, tuple) and hasattr(node, "_fields"):
        for f in node._fields:
            if f not in node._field_defaults:
                _flat_port(getattr(node, f), f"{path}/{f}", out)
    else:
        out[path] = tuple(node)
    return out


def _flat_jax(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/" + "/".join(str(k.key) for k in p): v for p, v in leaves}


@pytest.fixture(scope="module")
def jax_params():
    return {a: jax.eval_shape(lambda k, c=jget_config(a): JT.init_params(k, c),
                              jax.random.PRNGKey(0)) for a in list_archs()}


@pytest.fixture(scope="module")
def port_params():
    return {a: T.init_params(get_config(a), device="meta") for a in list_archs()}


@pytest.fixture(scope="module")
def jax_state_specs(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_launch") / "specs.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(out),
                          json.dumps(MESHES)], env=env, capture_output=True,
                         text=True, timeout=300)
    assert "JAX_OK" in res.stdout, res.stdout + res.stderr[-3000:]
    return json.loads(out.read_text())


# ---------------------------------------------------------------------------
# partition rules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_param_pspecs_match_jax_leaf_for_leaf(jax_params, port_params,
                                              mesh_name):
    shape, names = MESHES[mesh_name]
    jmesh, pmesh = _abstract_mesh(shape, names), lm.MeshShape(names, shape)
    for arch in list_archs():
        cfg = get_config(arch)
        want = {p: tuple(s) for p, s in _flat_jax(jsh.param_pspecs(
            jax_params[arch], jget_config(arch), jmesh)).items()}
        got = _flat_port(sharding.param_pspecs(port_params[arch], cfg, pmesh))
        assert got == want, arch


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_rules_and_input_specs_match_jax(mesh_name):
    shape, names = MESHES[mesh_name]
    jmesh, pmesh = _abstract_mesh(shape, names), lm.MeshShape(names, shape)
    assert sharding.INPUT_SHAPES == jsh.INPUT_SHAPES
    assert sharding.LONG_CONTEXT_OK == jsh.LONG_CONTEXT_OK
    assert sharding.FSDP_THRESHOLD == jsh.FSDP_THRESHOLD
    assert sharding.batch_pspec(pmesh) == tuple(jsh.batch_pspec(jmesh))
    for arch in list_archs():
        jcfg, cfg = jget_config(arch), get_config(arch)
        assert sharding.logical_rules(pmesh, cfg) == \
            jsh.logical_rules(jmesh, jcfg)
        for s, sh in jsh.INPUT_SHAPES.items():
            if sh["kind"] not in ("train", "prefill"):
                continue
            jshapes, jspecs = jsh.input_specs(jcfg, s, jmesh)
            shapes, specs = sharding.input_specs(cfg, s, pmesh)
            assert list(shapes) == list(jshapes)
            for k, (shp, dt) in shapes.items():
                assert shp == jshapes[k].shape
                assert str(dt).split(".")[-1] == jnp.dtype(jshapes[k].dtype).name
                assert specs[k] == tuple(jspecs[k])


def test_decode_state_pspecs_match_jax(jax_state_specs):
    for key, want in jax_state_specs.items():
        arch, mname, s = key.split("|")
        shape, names = MESHES[mname]
        cfg = get_config(arch)
        sh = sharding.INPUT_SHAPES[s]
        got = _flat_port(dryrun.decode_state_pspecs(
            cfg, lm.MeshShape(names, shape), sh["global_batch"],
            dryrun.cache_len_for(cfg, sh["seq_len"])))
        assert got == {p: _tup(v) for p, v in want.items()}, key


def test_production_meshes_and_backend_rule():
    assert lm.make_production_mesh() == lm.MeshShape(("data", "model"), (16, 16))
    m = lm.make_production_mesh(multi_pod=True)
    assert (m.axis_names, m.shape, m.size) == (("pod", "data", "model"),
                                               (2, 16, 16), 512)
    assert lm.batch_axes(m) == ("pod", "data") and lm.model_axis(m) == "model"
    assert lm.choose_backend(8, "cpu")[0] == "gloo"
    if torch.cuda.device_count() == 0:
        assert lm.choose_backend(1, "cuda")[0] == "gloo"


def test_to_placements_gives_a_spec_as_dtensor_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = lm.make_production_mesh(multi_pod=True)
    assert sharding.to_placements((("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert sharding.to_placements((None, "data"), mesh) == \
        (Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError):
        sharding.to_placements(("model", "model"), mesh)
    with pytest.raises(ValueError):
        sharding.to_placements((("data", "pod"),), mesh)


# ---------------------------------------------------------------------------
# shard_params
# ---------------------------------------------------------------------------
def _coords(shape, names):
    for idx in np.ndindex(*shape):
        yield dict(zip(names, (int(i) for i in idx)))


def _join(pieces, spec, sizes):
    """Undo ``shard_params``'s plain split: concatenate over each sharded
    dim, the last named axis fastest."""
    names = list(sizes)
    used = {a for ax in spec if ax is not None
            for a in (ax if isinstance(ax, tuple) else (ax,))}
    arr = {tuple(c[a] for a in names): p for c, p in pieces
           if all(c[a] == 0 for a in names if a not in used)}
    for dim in reversed(range(len(spec))):
        ax = spec[dim]
        if ax is None:
            continue
        for a in reversed(ax if isinstance(ax, tuple) else (ax,)):
            i = names.index(a)
            groups = {}
            for key, p in arr.items():
                groups.setdefault(key[:i] + (0,) + key[i + 1:], []).append(
                    (key[i], p))
            arr = {k: torch.cat([p for _, p in sorted(v, key=lambda t: t[0])],
                                dim=dim) for k, v in groups.items()}
    (out,) = arr.values()
    return out


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "deepseek-v2-236b",
                                  "qwen3-1.7b"])
def test_shard_params_slices_join_to_the_whole_leaf(arch):
    """On a (2, 4) mesh with the FSDP axis forced on: each leaf's slices
    over all ranks, joined again, give the leaf back."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    params = T.init_params(cfg, 0, device="cpu")
    shape, names = (2, 4), ("data", "model")
    mesh = lm.MeshShape(names, shape)
    specs = sharding.param_pspecs(params, cfg, mesh)
    ranks = [(c, sharding.shard_params(params, specs, mesh, coords=c))
             for c in _coords(shape, names)]
    from repro_torch.tree import tree_flatten
    whole, _ = tree_flatten(params)
    spec_leaves, _ = tree_flatten(specs)
    flats = [(c, tree_flatten(p)[0]) for c, p in ranks]
    sizes = dict(zip(names, shape))
    n_sharded = 0
    for i, (w, spec) in enumerate(zip(whole, spec_leaves)):
        n_sharded += any(a is not None for a in spec)
        got = _join([(c, f[i]) for c, f in flats], spec, sizes)
        assert torch.equal(got, w)
    assert n_sharded >= 3


def test_shard_params_gives_the_virtual_expert_slices():
    """E=2 experts on a model axis of 4: rank m gets slice m of
    ``repro/models/moe.py:206-211``'s reshape of the stacks (computed here
    with jnp), and ``execution_pspecs`` asks for that layout."""
    cfg = dataclasses.replace(get_smoke_config("mixtral-8x22b"), num_experts=2,
                              dtype="float32")
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    tree = {"moe": p}
    mesh = lm.MeshShape(("data", "model"), (1, 4))
    E, d, f, within = 2, cfg.d_model, cfg.moe_d_ff, 2
    f_loc = f // within
    jw = {n: jnp.asarray(p[n].numpy()) for n in ("w_gate", "w_up", "w_down")}
    want = {
        "w_gate": jw["w_gate"].reshape(E, d, within, f_loc)
        .transpose(0, 2, 1, 3).reshape(E * within, d, f_loc),
        "w_up": jw["w_up"].reshape(E, d, within, f_loc)
        .transpose(0, 2, 1, 3).reshape(E * within, d, f_loc),
        "w_down": jw["w_down"].reshape(E, within, f_loc, d)
        .reshape(E * within, f_loc, d)}
    for specs in (sharding.param_pspecs(tree, cfg, mesh),
                  sharding.execution_pspecs(tree, cfg, mesh)):
        for m in range(4):
            got = sharding.shard_params(tree, specs, mesh,
                                        coords={"data": 0, "model": m})["moe"]
            for n in want:
                np.testing.assert_array_equal(got[n].numpy(),
                                              np.asarray(want[n][m:m + 1]))
            assert torch.equal(got["router"]["w"], p["router"]["w"])


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------
def test_roofline_constants_are_the_h100s():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.NVLINK_BW) == \
        (989e12, 3.35e12, 450e9)
    t = roofline.roofline_terms(989e12, 3.35e12, 450e9)
    assert t["compute_s"] == t["memory_s"] == t["collective_s"] == 1.0


def test_model_flops_and_analytic_terms_match_jax():
    """model_flops equal; each analytic term times its constant equal to
    JAX's term times JAX's (the only change is the constants)."""
    pairs = [("a_compute_s", "PEAK_FLOPS", "PEAK_FLOPS"),
             ("a_memory_s", "HBM_BW", "HBM_BW"),
             ("a_collective_s", "NVLINK_BW", "ICI_BW")]
    for arch in dryrun.ASSIGNED:
        jcfg, cfg = jget_config(arch), get_config(arch)
        for s, sh in sharding.INPUT_SHAPES.items():
            assert roofline.model_flops(cfg, sh) == jrl.model_flops(jcfg, sh)
            for kw in (dict(n_devices=256, batch_shards=16, model_shards=16),
                       dict(n_devices=512, batch_shards=32, model_shards=16,
                            fsdp=True)):
                got = roofline.analytic_roofline(cfg, sh, **kw)
                want = jrl.analytic_roofline(jcfg, sh, **kw)
                for term, c, jc in pairs:
                    assert math.isclose(got[term] * getattr(roofline, c),
                                        want[term] * getattr(jrl, jc),
                                        rel_tol=1e-12)


def test_collective_bytes_reads_the_counter():
    counter = {"psum": {"count": 3, "bytes": 96}, "pmax": {"count": 1,
                                                           "bytes": 8},
               "pmean": {"count": 0, "bytes": 0}}
    assert roofline.collective_bytes(counter) == {"all-reduce": 104}
    assert roofline.collective_bytes({k: {"count": 0, "bytes": 0}
                                      for k in counter}) == {}


# ---------------------------------------------------------------------------
# the dry-run plan
# ---------------------------------------------------------------------------
def _jax_param_bytes(jparams, jcfg, mesh):
    specs = jsh.param_pspecs(jparams, jcfg, mesh)
    sizes = dict(mesh.shape)
    total = 0
    for leaf, spec in zip(jax.tree.leaves(jparams), jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))):
        n = math.prod(sizes[a] for ax in spec if ax is not None
                      for a in (ax if isinstance(ax, tuple) else (ax,)))
        total += leaf.size * jnp.dtype(leaf.dtype).itemsize // n
    return total


def test_plan_statuses_and_param_bytes_follow_jax(jax_params):
    for arch in dryrun.ASSIGNED:
        for mname, (shape, names) in MESHES.items():
            want_bytes = _jax_param_bytes(jax_params[arch], jget_config(arch),
                                          _abstract_mesh(shape, names))
            for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
                r = dryrun.run_one(arch, s, mname == "multi", verbose=False)
                if s == "long_500k" and arch not in jsh.LONG_CONTEXT_OK:
                    assert r["status"] == "skipped", (arch, s)
                    continue
                assert r["status"] == "ok", r
                assert r["param_bytes_per_device"] == want_bytes, (arch, mname)
                assert r["flops_per_device"] is None and r["mem"] is None
                assert (r["state_bytes_per_device"] > 0) == \
                    (sharding.INPUT_SHAPES[s]["kind"] == "decode")


def test_plan_main_prints_the_summary(capsys):
    rc = dryrun.main(["--arch", "qwen3-1.7b", "--shape", "train_4k",
                      "--mesh", "single"])
    out = capsys.readouterr().out
    assert rc == 0 and "DRYRUN SUMMARY: 1 ok" in out


# ---------------------------------------------------------------------------
# run_ranks
# ---------------------------------------------------------------------------
def test_run_ranks_raises_on_a_failed_rank(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        lm.run_ranks(torch_dist_workers.fail_on_rank_1, 2, device="cpu",
                     timeout_s=120, workdir=str(tmp_path), verbose=False)


def test_run_ranks_raises_on_a_rank_that_does_not_finish(tmp_path):
    with pytest.raises(TimeoutError):
        lm.run_ranks(torch_dist_workers.sleep, 1, device="cpu", timeout_s=3,
                     workdir=str(tmp_path), verbose=False)


def test_host_mesh_is_one_by_one_on_the_given_device(tmp_path):
    got, = lm.run_ranks(torch_dist_workers.host_mesh, 1, device="cpu",
                        timeout_s=120, workdir=str(tmp_path), verbose=False)
    assert got == (("data", "model"), (1, 1), "cpu")
