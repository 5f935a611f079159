"""The LoRA slice as a whole: the port's partial-parameter rounds
(``FFTRunner(..., lora_cfg=...)`` with FedAvg, FedEx-LoRA and FedAuto, Table
4's strategies) against the JAX package's on the same split, seed, converted
base weights and adapters and minibatch indices, on a small ViT.  After every
round the adapters and the frozen base must agree within 1e-4, and the
accuracy histories within one test sample.  Uploads go through the
``lora_only`` codec on both sides."""
import jax
import numpy as np
import pytest
import torch

from repro.core.strategies import FedAuto as JFedAuto
from repro.core.strategies import FedAvg as JFedAvg
from repro.core.strategies import FedExLoRA as JFedExLoRA
from repro.data.synthetic import fft_split, make_dataset, train_test_split
from repro.fl.lora import LoRAConfig as JLoRAConfig
from repro.fl.lora import lora_init as jax_lora_init
from repro.fl.partition import partition
from repro.fl.runtime import FFTConfig as JFFTConfig
from repro.fl.runtime import FFTRunner as JFFTRunner
from repro.models import vision as jvision
from repro_torch.convert import params_from_jax
from repro_torch.core.strategies import STRATEGIES, FedAuto, FedAvg, FedExLoRA
from repro_torch.fl.lora import LoRAConfig, lora_paths
from repro_torch.fl.runtime import FFTConfig, FFTRunner
from repro_torch.kernels import ops
from repro_torch.models import vision
from repro_torch.tree import tree_leaves
from test_torch_runner import JaxMinibatchIndices

# a small ViT (d 32, 2 blocks, 2 heads) on 8x8 images: 5 tokens per image;
# uploads priced at 100 kB so that the wireless clients drop out at times
VIT = dict(patch=4, heads=2, depth=2)
CFG = dict(n_clients=6, k_selected=4, local_steps=2, batch_size=8, lr=0.1,
           failure_mode="mixed", tx_delay_s=0.01, model_bytes=1e5, seed=0,
           eval_every=1, codec="lora_only")
RANK = 4
N_TEST = 120
ROUNDS = 3


def _match(path):
    return "qkv/w" in path


class RetracingJaxRunner(JFFTRunner):
    """The JAX runner with its jitted closures rebuilt whenever its base
    weights change.  ``repro.fl.runtime.FFTRunner`` traces ``base_params``
    into its jitted local update and evaluation as constants, so FedEx-LoRA's
    ``fold_into_base`` never reaches later training or evaluation there
    (ROADMAP, faults found against the reference).  The port uses the
    folded base, so the comparison retraces."""
    _stale = False

    def set_base(self, base):
        self.base_params = base
        self._stale = True

    def fold_into_base(self, path, resid):
        super().fold_into_base(path, resid)
        self._stale = True

    def _fresh(self):
        if self._stale:
            self._build_jits()
            self._stale = False

    def run_local(self, *args, **kwargs):
        self._fresh()
        return super().run_local(*args, **kwargs)

    def evaluate(self):
        self._fresh()
        return super().evaluate()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _run(runner, strategy, base, adapters, set_base):
    set_base(base())
    runner.global_params = adapters
    runner.rng = np.random.default_rng(42)
    snaps = []

    def log(r, acc):
        snaps.append((runner.global_params, dict(_flat(runner.base_params))))

    hist = runner.run(strategy, ROUNDS, log=log)
    return dict(hist=hist, snaps=snaps,
                participants=list(runner.loop.participants_per_round))


def _flat(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def make_pair():
    """One retracing JAX runner and one port runner of the small ViT in
    LoRA mode, on the same split, base and adapters, after 4 pretraining
    steps.  Returns ``(jax runner, port runner, base as numpy)``."""
    ds = make_dataset(600, n_classes=10, image_size=8, channels=1, seed=0)
    train, test = train_test_split(ds, N_TEST, seed=1)
    public, private = fft_split(train, public_per_class=5, seed=0)
    parts, _ = partition("group_classes", private.y, n_clients=6,
                         n_classes=10, classes_per_group=2, seed=0)
    base_np = _np(jvision.vit_init(jax.random.PRNGKey(0), 10, 8, 1, d=32,
                                   depth=2, heads=2))
    jcfg = JLoRAConfig(rank=RANK, match=_match)
    ad_np = _np(jax_lora_init(jax.random.PRNGKey(1), base_np, jcfg))

    jr = RetracingJaxRunner(
        JFFTConfig(**CFG), lambda k: jax.tree.map(jax.numpy.asarray, base_np),
        lambda p, x: jvision.vit_apply(p, x, **VIT), public, parts, private,
        test, lora_cfg=jcfg)
    tr = FFTRunner(FFTConfig(**CFG),
                   lambda s: params_from_jax(base_np, device="cpu"),
                   lambda p, x: vision.vit_apply(p, x, **VIT), public, parts,
                   private, test, lora_cfg=LoRAConfig(rank=RANK, match=_match),
                   device="cpu",
                   batch_indices=JaxMinibatchIndices(CFG["seed"]))
    jr.global_params = jax.tree.map(jax.numpy.asarray, ad_np)
    tr.global_params = params_from_jax(ad_np, device="cpu")
    jr.pretrain(4)
    tr.pretrain(4)
    return jr, tr, base_np


@pytest.fixture(scope="module")
def runs():
    jr, tr, base_np = make_pair()
    out = {"pretrain": {
               side: dict(snaps=[(r.global_params, dict(_flat(r.base_params)))])
               for side, r in (("jax", jr), ("torch", tr))},
           "upload_bytes": (jr.comm.fp32_nbytes, tr.comm.fp32_nbytes,
                            jr.upload_bytes, tr.upload_bytes),
           "launches": {}}
    jg0, tg0 = jr.global_params, tr.global_params
    for name, js, ts in (("fedavg", JFedAvg, FedAvg),
                         ("fedex_lora", JFedExLoRA, FedExLoRA),
                         ("fedauto", JFedAuto, FedAuto)):
        ops.reset_launches()
        out[name] = dict(
            jax=_run(jr, js(), lambda: jax.tree.map(jax.numpy.asarray, base_np),
                     jg0, jr.set_base),
            torch=_run(tr, ts(), lambda: params_from_jax(base_np, device="cpu"),
                       tg0, lambda b: setattr(tr, "base_params", b)))
        out["launches"][name] = dict(ops.launches)
    out["base_np"] = base_np
    return out


RUNS = ["fedavg", "fedex_lora", "fedauto"]


@pytest.mark.parametrize("name", ["pretrain"] + RUNS)
def test_adapters_and_base_match_jax_after_every_round(runs, name):
    j, t = runs[name]["jax"], runs[name]["torch"]
    assert len(j["snaps"]) == len(t["snaps"]) >= 1
    for (jad, jbase), (tad, tbase) in zip(j["snaps"], t["snaps"]):
        jl, tl = jax.tree.leaves(_np(jad)), tree_leaves(tad)
        assert len(jl) == len(tl) == 2 * 2          # (a, b) x 2 blocks
        for a, b in zip(tl, jl):
            assert tuple(a.shape) == b.shape and a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4)
        assert sorted(jbase) == sorted(tbase)
        for path, leaf in tbase.items():
            np.testing.assert_allclose(leaf.numpy(), np.asarray(jbase[path]),
                                       rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", RUNS)
def test_accuracy_history_and_participation_match_jax(runs, name):
    j, t = runs[name]["jax"], runs[name]["torch"]
    assert t["participants"] == j["participants"]
    assert len(t["hist"]) == len(j["hist"]) == ROUNDS
    for a, b in zip(t["hist"], j["hist"]):
        assert abs(a - b) <= 1.0 / N_TEST + 1e-12


@pytest.mark.parametrize("name", RUNS)
def test_only_fedex_lora_moves_the_base_and_only_at_adapted_leaves(runs, name):
    """FedAvg and FedAuto leave the frozen base bit-identical; FedEx-LoRA
    folds a nonzero residual into the adapted ``qkv/w`` leaves and nowhere
    else."""
    base0 = dict(_flat(runs["base_np"]))
    _, base = runs[name]["torch"]["snaps"][-1]
    adapted = {p for p in base if _match(p)}
    assert adapted == {"blk0/qkv/w", "blk1/qkv/w"}
    for path, leaf in base.items():
        same = np.array_equal(leaf.numpy(), base0[path])
        assert same == (name != "fedex_lora" or path not in adapted), path


def test_lora_rounds_launch_no_kernel_on_the_cpu(runs):
    """CPU tensors take the plain versions, which are never counted; the
    counters are checked on the card by ``chip_smoke.py``."""
    for name in RUNS:
        assert set(runs["launches"][name].values()) == {0}


def test_uploads_are_adapter_sized(runs):
    j_exact, t_exact, j_priced, t_priced = runs["upload_bytes"]
    assert t_exact == j_exact == 4 * 2 * (32 * RANK + RANK * 96)
    assert t_priced == j_priced == CFG["model_bytes"]


def test_rounds_see_partial_cohorts(runs):
    seen = [n for name in RUNS for n in runs[name]["torch"]["participants"]]
    assert min(seen) < CFG["k_selected"] and max(seen) > 1


# ---------------------------------------------------------------------------
def test_fedex_lora_is_registered_and_lora_only_refuses_full_params():
    assert STRATEGIES["fedex_lora"] is FedExLoRA
    ds = make_dataset(60, n_classes=10, image_size=8, channels=1, seed=0)
    init_fn, apply_fn = vision.make_model("cnn", 10, 8, 1, device="cpu")
    with pytest.raises(ValueError, match="lora_only"):
        FFTRunner(FFTConfig(**CFG), init_fn, apply_fn, ds,
                  [np.arange(10)] * 6, ds, ds, device="cpu")


def test_lora_runner_defaults_to_cuda():
    init_fn, apply_fn = vision.make_model("vit", 10, 8, 1, device="cpu")
    ds = make_dataset(60, n_classes=10, image_size=8, channels=1, seed=0)
    args = (FFTConfig(**CFG), init_fn, apply_fn, ds, [np.arange(10)] * 6, ds, ds)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            FFTRunner(*args, lora_cfg=LoRAConfig(rank=RANK, match=_match))
    r = FFTRunner(*args, lora_cfg=LoRAConfig(rank=RANK, match=_match),
                  device="cpu")
    assert sorted(r.global_params) == sorted(
        lora_paths(r.base_params, r.lora_cfg))
    assert all(not t.requires_grad for t in tree_leaves(r.base_params))
    assert r.comm.fp32_nbytes == 4 * sum(t.numel() for t in
                                         tree_leaves(r.global_params))
