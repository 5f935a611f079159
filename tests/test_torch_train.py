"""The port's LLM training path against the JAX package's, on
qwen3-1.7b-smoke in fp32 with the JAX params carried across leaf for leaf
and the same numpy batches:

  * the loss and gradient of ``T.forward`` (``launch.train.value_and_grad``)
    against ``jax.value_and_grad(T.forward)``, remat on and off;
  * 5 steps of ``launch.train.train`` against the JAX script's
    ``train_step`` loop (AdamW, warmup-cosine, the bigram stream);
  * ``fl.parallel.make_fft_round_step`` against the JAX package's (vmap)
    with one client's β = 0, which must leave the port's result bitwise
    the same whatever that client's tokens;
  * ``launch.fft_lora_llm.run`` against ``examples/fft_lora_llm.py``'s
    loop, rebuilt here from ``repro`` functions, for 2 rounds, on
    qwen3-1.7b-smoke and on gemma-7b-smoke, starcoder2-7b-smoke,
    mixtral-8x22b-smoke and llava-next-mistral-7b-smoke.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.core.aggregation import aggregate_pytrees as jaggregate
from repro.core.aggregation import fedauto_weights as jfedauto_weights
from repro.data import tokens as jtokens
from repro.fl import lora as jlora
from repro.fl import parallel as jparallel
from repro.models import transformer as JT
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import warmup_cosine as jwarmup_cosine
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.fl.parallel import make_fft_round_step
from repro_torch.launch import fft_lora_llm, train
from repro_torch.tree import tree_leaves

ARCH = "qwen3-1.7b"
LOSS_TOL = 1e-5
LEAF_TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs(arch=ARCH):
    return (dataclasses.replace(jget_smoke(arch), dtype="float32"),
            dataclasses.replace(get_smoke_config(arch), dtype="float32"))


def _params(jcfg, seed=0):
    jp = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _batch(vocab, shape, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, shape).astype(np.int32)
    labels = rng.integers(0, vocab, shape).astype(np.int32)
    return toks, labels


def _same_leaves(got, want, tol=LEAF_TOL):
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   np.asarray(b, np.float32), **tol)


@pytest.mark.parametrize("remat", [True, False])
def test_forward_and_backward_match_jax(remat):
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg)
    toks, labels = _batch(cfg.vocab_size, (2, 32), seed=1)
    labels[0, :3] = -1                                  # masked targets
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    jloss, jgrads = jax.value_and_grad(
        lambda p: JT.forward(p, jcfg, jbatch, loss_chunk=16, remat=remat)[0])(jp)
    loss, grads = train.value_and_grad(cfg, tp, torch.from_numpy(toks),
                                       torch.from_numpy(labels), loss_chunk=16,
                                       remat=remat)
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL
    _same_leaves(grads, jgrads)


def test_train_steps_match_the_jax_train_script():
    """5 steps of the port's training loop and of the JAX script's jitted
    ``train_step`` on the same stream, batches and schedule."""
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg, seed=3)
    steps, batch, seq, lr = 5, 2, 32, 3e-3
    tp, _, losses, _ = train.train(cfg, tp, steps=steps, batch=batch, seq=seq,
                                   lr=lr, log_every=steps)

    opt = jadamw_init(jp)
    sched = jwarmup_cosine(lr, warmup=20, total=steps)
    stream = jtokens.make_bigram_stream(500_000, jcfg.vocab_size, domain=0,
                                        n_domains=1, seed=0)
    batches = jtokens.batches_from_stream(stream, batch, seq, seed=0)

    @jax.jit
    def train_step(params, opt_state, toks, labels, lr_):
        loss, grads = jax.value_and_grad(lambda p: JT.forward(
            p, jcfg, {"tokens": toks, "labels": labels},
            q_chunk=min(seq, 2048), loss_chunk=256)[0])(params)
        params, opt_state = jadamw_update(params, grads, opt_state, lr_)
        return params, opt_state, loss

    jlosses = []
    for step in range(1, steps + 1):
        toks, labels = next(batches)
        jp, opt, loss = train_step(jp, opt, jnp.asarray(toks),
                                   jnp.asarray(labels), sched(step))
        jlosses.append(float(loss))
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=LOSS_TOL)
    _same_leaves(tp, jp)


def test_fft_round_matches_jax_and_ignores_a_client_with_zero_beta():
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg, seed=4)
    K, b, S = 3, 2, 32
    toks, labels = _batch(cfg.vocab_size, (K, b, S), seed=5)
    beta = np.array([0.6, 0.0, 0.4], np.float32)
    jround = jparallel.make_fft_round_step(jcfg, lr=1e-2, q_chunk=S,
                                           loss_chunk=S)
    jnew, jloss = jround(jp, jnp.asarray(toks), jnp.asarray(labels),
                         jnp.asarray(beta))
    fft_round = make_fft_round_step(cfg, lr=1e-2, loss_chunk=S)
    new, loss = fft_round(tp, torch.from_numpy(toks), torch.from_numpy(labels),
                          torch.from_numpy(beta))
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL
    _same_leaves(new, jnew)
    other = toks.copy()
    other[1] = (other[1] + 1) % cfg.vocab_size
    new2, loss2 = fft_round(tp, torch.from_numpy(other),
                            torch.from_numpy(labels), torch.from_numpy(beta))
    assert float(loss2) == float(loss)
    assert all(torch.equal(a, c) for a, c in zip(tree_leaves(new),
                                                  tree_leaves(new2)))


def _jax_lora_loop(jcfg, base, adapters, *, rounds, clients, local_steps, seq):
    """``examples/fft_lora_llm.py``'s loop, with its base and adapters
    given; returns (adapters, connected per round, β per round)."""
    lcfg = jlora.LoRAConfig(rank=4, alpha=8.0,
                            match=lambda p: p.endswith("wq/w") or p.endswith("wv/w"))
    n_buckets = 32
    streams = [jtokens.make_bigram_stream(20_000, jcfg.vocab_size, domain=i,
                                          n_domains=clients, seed=0)
               for i in range(clients)]
    server_stream = np.concatenate(
        [jtokens.make_bigram_stream(4_000, jcfg.vocab_size, domain=i,
                                    n_domains=clients, seed=1)
         for i in range(clients)])
    hists = np.stack([jtokens.token_class_histogram(s, n_buckets) for s in streams])
    server_hist = jtokens.token_class_histogram(server_stream, n_buckets)
    global_hist = server_hist + hists.sum(0)

    def loss_fn(ad, toks, labels):
        params = jlora.apply_lora(base, ad, lcfg)
        return JT.forward(params, jcfg, {"tokens": toks, "labels": labels},
                          q_chunk=seq, loss_chunk=seq)[0]

    @jax.jit
    def local_update(ad, toks, labels, lr):
        def step(a, _):
            l, g = jax.value_and_grad(loss_fn)(a, toks, labels)
            return jax.tree.map(lambda p, gg: p - lr * gg, a, g), l
        ad, losses = jax.lax.scan(step, ad, None, length=local_steps)
        return ad, losses[-1]

    iters = [jtokens.batches_from_stream(s, 4, seq, seed=i)
             for i, s in enumerate(streams)]
    server_iter = jtokens.batches_from_stream(server_stream, 4, seq, seed=99)
    rng = np.random.default_rng(0)
    connected, betas = [], []
    for _ in range(rounds):
        up = rng.uniform(size=clients) > 0.35
        toks, labels = next(server_iter)
        models = [local_update(adapters, jnp.asarray(toks), jnp.asarray(labels),
                               1e-2)[0]]
        rows = [server_hist / server_hist.sum()]
        for i in range(clients):
            if not up[i]:
                continue
            toks, labels = next(iters[i])
            models.append(local_update(adapters, jnp.asarray(toks),
                                       jnp.asarray(labels), 1e-2)[0])
            rows.append(hists[i] / hists[i].sum())
        beta = jfedauto_weights(np.stack(rows), global_hist / global_hist.sum(),
                                np.ones(len(rows), bool), 0)
        adapters = jaggregate(models, beta)
        connected.append(up)
        betas.append(np.asarray(beta))
    return adapters, connected, betas


# qwen3-1.7b's and the dense configs' LoRA gradients: gemma-7b's sqrt(d)-scaled
# embeddings, GeGLU, hd 48 and tied head; starcoder2-7b's attention biases,
# hd 24 and sliding window; mixtral-8x22b's adapters beside its MoE blocks
# (the frozen experts' input gradients); llava-next-mistral-7b on text
@pytest.mark.parametrize("arch", [ARCH, "gemma-7b", "starcoder2-7b",
                                  "mixtral-8x22b", "llava-next-mistral-7b"])
def test_fft_lora_llm_rounds_match_the_jax_example(arch):
    jcfg, cfg = _cfgs(arch)
    jbase, tbase = _params(jcfg, seed=0)
    lcfg = jlora.LoRAConfig(rank=4, alpha=8.0,
                            match=lambda p: p.endswith("wq/w") or p.endswith("wv/w"))
    jad = jlora.lora_init(jax.random.fold_in(jax.random.PRNGKey(0), 1), jbase, lcfg)
    tad = params_from_jax(jax.tree.map(np.asarray, jad), device="cpu")
    kw = dict(rounds=2, clients=4, local_steps=2, seq=32)
    want, want_up, want_beta = _jax_lora_loop(jcfg, jbase, jad, **kw)
    out = fft_lora_llm.run(cfg, device="cpu", base=tbase, adapters=tad, **kw)
    assert len(tree_leaves(out["adapters"])) == 4
    for got_up, up in zip(out["connected"], want_up):
        np.testing.assert_array_equal(got_up, up)
    # the QP's tolerance in test_torch_aggregation.py: 400 fp32 FISTA
    # iterations in another order (1.4e-6 apart here)
    for got_b, b in zip(out["beta"], want_beta):
        np.testing.assert_allclose(got_b, b, rtol=0, atol=1e-5)
    _same_leaves(out["adapters"], want)
    assert out["base"] is tbase
