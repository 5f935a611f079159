"""The port's serving loop (``repro_torch.launch.serve``) against the JAX
package's: the same prompts and params give the same greedy tokens."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import transformer as JT
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve

ARCH = "qwen3-1.7b"


def _jax_generate(params, cfg, prompts, decode_steps, cache_len):
    """``repro/launch/serve.py``'s decode loop, greedy."""
    B = prompts.shape[0]
    state = JT.init_decode_state(params, cfg, B, cache_len)
    decode = jax.jit(lambda p, s, t: JT.decode_step(p, cfg, s, t))
    for t in range(prompts.shape[1]):
        logits, state = decode(params, state, prompts[:, t:t + 1])
    tok = jnp.argmax(logits, -1)[:, None]
    out = [np.asarray(tok)]
    for _ in range(decode_steps):
        logits, state = decode(params, state, tok)
        tok = jnp.argmax(logits, -1)[:, None]
        out.append(np.asarray(tok))
    return np.concatenate(out, 1)


@pytest.mark.parametrize("cache_len", [32, 12])     # 12: the ring wraps
def test_generate_greedy_tokens_match_jax(cache_len):
    jcfg = dataclasses.replace(jget_smoke(ARCH), dtype="float32")
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    jp = JT.init_params(jax.random.PRNGKey(7), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    prompts = np.random.default_rng(4).integers(0, cfg.vocab_size, (3, 8)).astype(np.int32)
    want = _jax_generate(jp, jcfg, jnp.asarray(prompts), 10, cache_len)
    res = serve.generate(tp, cfg, torch.from_numpy(prompts).long(), 10, cache_len)
    assert res["tokens"].shape == (3, 11)
    np.testing.assert_array_equal(res["tokens"].numpy(), want)
    assert res["prefill_s"] > 0 and res["decode_s"] > 0 and res["tok_s"] > 0


def test_generate_samples_from_its_generator():
    cfg = get_smoke_config(ARCH)
    from repro_torch.models import transformer as T
    params = T.init_params(cfg, seed=1, device="cpu")
    prompts = torch.randint(0, cfg.vocab_size, (2, 4),
                            generator=torch.Generator().manual_seed(0))
    runs = [serve.generate(params, cfg, prompts, 6, 16, temperature=1.0,
                           generator=torch.Generator().manual_seed(s))["tokens"]
            for s in (5, 5, 6)]
    assert torch.equal(runs[0], runs[1])
    assert runs[0].shape == (2, 7)
    assert int(runs[0].min()) >= 0 and int(runs[0].max()) < cfg.vocab_size
    assert torch.equal(runs[0][:, 0], runs[2][:, 0])   # first token is greedy


def test_main_decodes_on_the_cpu_and_refuses_broadcast(capsys):
    res = serve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "4",
                      "--decode-steps", "3", "--cache-len", "16", "--seed", "1"])
    out = capsys.readouterr().out
    assert "arch=qwen3-1.7b-smoke B=2 prefill(4 tok)=" in out and "tok/s" in out
    assert res["tokens"].shape == (2, 4)
    again = serve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "4",
                        "--decode-steps", "3", "--cache-len", "16", "--seed", "1"])
    assert torch.equal(res["tokens"], again["tokens"])
    # --mode broadcast runs (tests/test_torch_codecs.py); an adaptive spec
    # is no rung, and it refuses it as the JAX package's serve does
    with pytest.raises(ValueError, match="unknown codec"):
        serve.main(["--mode", "broadcast", "--device", "cpu",
                    "--rungs", "int8,adaptive:sign1-fp16"])
