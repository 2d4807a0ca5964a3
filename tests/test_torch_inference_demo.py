"""The port's LLM inference demo (``repro_torch.launch.inference_demo``) on
the CPU: its CLI with ``--device cpu`` on reduced smollm-360m, reduced
rwkv6-1.6b, reduced mixtral-8x22b, reduced llava-next-34b and reduced
hymba-1.5b (a prompt longer than its window of 64), its default
device (the card) refused on a host without CUDA, an encoder-decoder
refused as the reference's demo refuses it, and its prefill + greedy
decode against the JAX package's demo loop on the same weights (smollm,
llava with the frontend embeddings drawn as the reference's demo draws
them and its short cache, and hymba with a prompt that wraps the KV ring
buffer): the same greedy tokens, and the prefill logits
within atol = rtol = 1e-5 (float32; the two sides differ only in
summation order).
"""
import jax
import jax.experimental

# this jax names the x64 context manager jax.enable_x64; the reference
# kernels import it from jax.experimental. Set here so this file does not
# depend on collection order.
jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro_torch.launch import inference_demo as demo
from repro_torch.models import build_model
from repro_torch.models.convert import (model_config_from_reference,
                                        params_from_reference)


def _run_cli(capsys, arch):
    demo.main(["--arch", arch, "--reduced", "--batch", "3",
               "--prompt-len", "20", "--gen", "5", "--device", "cpu"])
    return capsys.readouterr().out.strip().splitlines()


def test_cli_runs_on_cpu(capsys):
    lines = _run_cli(capsys, "smollm-360m")
    assert lines[0].startswith("prefill 3×20 in ")
    assert lines[1].startswith("decoded 4 steps × 3 seqs in ")
    assert lines[1].endswith("tok/s)")
    assert lines[2].startswith("sample: [")
    sample = [int(t) for t in lines[2][len("sample: ["):-1].split()]
    assert len(sample) == 5 and all(0 <= t < 512 for t in sample)


def test_cli_runs_rwkv_on_cpu(capsys):
    lines = _run_cli(capsys, "rwkv6-1.6b")
    assert lines[0].startswith("prefill 3×20 in ")
    assert lines[1].startswith("decoded 4 steps × 3 seqs in ")
    sample = [int(t) for t in lines[2][len("sample: ["):-1].split()]
    assert len(sample) == 5 and all(0 <= t < 512 for t in sample)


def test_cli_runs_mixtral_on_cpu(capsys):
    lines = _run_cli(capsys, "mixtral-8x22b")
    assert lines[0].startswith("prefill 3×20 in ")
    assert lines[1].startswith("decoded 4 steps × 3 seqs in ")
    sample = [int(t) for t in lines[2][len("sample: ["):-1].split()]
    assert len(sample) == 5 and all(0 <= t < 512 for t in sample)


def test_cli_runs_llava_on_cpu(capsys):
    lines = _run_cli(capsys, "llava-next-34b")
    assert lines[0].startswith("prefill 3×20 in ")
    assert lines[1].startswith("decoded 4 steps × 3 seqs in ")
    sample = [int(t) for t in lines[2][len("sample: ["):-1].split()]
    assert len(sample) == 5 and all(0 <= t < 512 for t in sample)


def test_cli_runs_hymba_on_cpu(capsys):
    """The hybrid: a prompt of 80 over the reduced window of 64."""
    demo.main(["--arch", "hymba-1.5b", "--reduced", "--batch", "3",
               "--prompt-len", "80", "--gen", "5", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("prefill 3×80 in ")
    assert lines[1].startswith("decoded 4 steps × 3 seqs in ")
    sample = [int(t) for t in lines[2][len("sample: ["):-1].split()]
    assert len(sample) == 5 and all(0 <= t < 512 for t in sample)


def test_cli_refuses_an_encoder_decoder():
    with pytest.raises(SystemExit, match="decoder-only"):
        demo.main(["--arch", "seamless-m4t-large-v2", "--reduced",
                   "--device", "cpu"])


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        demo.main(["--arch", "smollm-360m", "--reduced"])


def test_generate_matches_reference_demo_loop():
    _generate_matches_reference_demo_loop("smollm-360m", 24)


def test_hybrid_generate_matches_reference_demo_loop():
    """hymba's prompt of 80 wraps its window of 64: the decode steps write
    the KV ring buffer from slot 80 % 64 and carry the Mamba state."""
    _generate_matches_reference_demo_loop("hymba-1.5b", 80)


def _generate_matches_reference_demo_loop(arch, P):
    B, gen = 2, 6
    ref_cfg = ref_get_config(arch, reduced=True)
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    prompts = np.random.default_rng(0).integers(0, ref_cfg.vocab, (B, P))

    # the reference demo's loop (repro/launch/inference_demo.py)
    logits, cache = ref_model.prefill(ref_params, jnp.asarray(prompts), P + gen)
    ref_logits = np.asarray(logits)
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None]
    want = [np.asarray(tok)]
    for _ in range(gen - 1):
        logits, cache = ref_model.decode_step(ref_params, cache, tok)
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None]
        want.append(np.asarray(tok))
    want = np.concatenate(want, axis=1)

    model = build_model(model_config_from_reference(ref_cfg), device="cpu")
    model.load_state_dict(params_from_reference(
        jax.tree_util.tree_map(np.asarray, ref_params)))
    with torch.inference_mode():
        out = demo.generate(model, torch.from_numpy(prompts), gen)
    np.testing.assert_allclose(out["logits"].numpy(), ref_logits,
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(out["tokens"].numpy(), want)


def test_vlm_generate_matches_reference_demo_loop():
    """llava reduced as the reference's demo runs it: the frontend
    embeddings drawn from the prompts' generator after them
    (``rng.normal(0, 0.02, ...)``), a cache of ``prompt_len + gen`` (which
    the prefill overfills), greedy decode."""
    B, P, gen, seed = 2, 12, 5, 3
    ref_cfg = ref_get_config("llava-next-34b", reduced=True)
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, ref_cfg.vocab, (B, P))
    fe = jnp.asarray(rng.normal(0, 0.02, (B, ref_cfg.n_frontend_embeds,
                                         ref_cfg.d_model)), ref_cfg.dtype)
    logits, cache = ref_model.prefill(ref_params, jnp.asarray(prompts),
                                      P + gen, frontend_embeds=fe)
    ref_logits = np.asarray(logits)
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None]
    want = [np.asarray(tok)]
    for _ in range(gen - 1):
        logits, cache = ref_model.decode_step(ref_params, cache, tok)
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None]
        want.append(np.asarray(tok))
    want = np.concatenate(want, axis=1)

    model = build_model(model_config_from_reference(ref_cfg), device="cpu")
    model.load_state_dict(params_from_reference(
        jax.tree_util.tree_map(np.asarray, ref_params)))
    cpu = torch.device("cpu")
    got_prompts, got_fe = demo.make_inputs(model.cfg, B, P, seed, cpu)
    np.testing.assert_array_equal(got_prompts.numpy(), prompts)
    np.testing.assert_array_equal(got_fe.numpy(), np.asarray(fe))
    with torch.inference_mode():
        out = demo.generate(model, got_prompts, gen, frontend_embeds=got_fe)
    np.testing.assert_allclose(out["logits"].numpy(), ref_logits,
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(out["tokens"].numpy(), want)
