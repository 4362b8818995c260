"""Serving the moe, vlm and audio families: greedy ``ServeEngine.generate``
tokens equal the JAX package's (exact), with the family's extra inputs.

Reduced grok-1-314b, llama4-scout-17b-a16e, paligemma-3b and
whisper-large-v3 with ``attn_impl="flash"`` on both sides (the port's plain
flash on the CPU, the reference's Pallas kernel in interpret mode), the same
perturbed parameters, image embeddings or frames from a numpy generator
passed as ``extra_inputs``, prompts of several lengths (paligemma's at least
``n_img_tokens`` long: a shorter prompt would change the sequence length in
the reference, which concatenates all image rows before ``x[:, n_img:]``).
"""
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import reduced_config as j_reduced
from repro.models.lm import build_model as j_build
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.models.convert import params_from_jax
from repro_torch.models.lm import build_model
from repro_torch.serve.engine import ServeEngine
from _families import FAMILY_ARCHS, model_inputs, perturbed_params

MAX_SEQ, NEW_TOKENS = 24, 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_greedy_tokens_equal_reference(arch):
    jcfg, tcfg = j_reduced(JARCHS[arch]), reduced_config(ARCHS[arch])
    tree = perturbed_params(jcfg, seed=2)
    extra = {k: v for k, v in model_inputs(tcfg, 1, 1, seed=6).items()
             if k != "tokens"}
    rng = np.random.default_rng(7)
    lengths = (tcfg.n_img_tokens or 2, 5, 11)
    prompts = [[int(t) for t in rng.integers(0, tcfg.vocab_size, size=n)]
               for n in lengths]
    want = JServeEngine(j_build(jcfg, attn_impl="flash"), tree,
                        max_seq=MAX_SEQ).generate(
        prompts, max_new_tokens=NEW_TOKENS, extra_inputs=extra)
    eng = ServeEngine(build_model(tcfg, attn_impl="flash"),
                      params_from_jax(tree, tcfg, device="cpu"),
                      max_seq=MAX_SEQ, device="cpu")
    got = eng.generate(prompts, max_new_tokens=NEW_TOKENS, extra_inputs={
        k: torch.from_numpy(v) for k, v in extra.items()})
    assert got == want
    assert [t.prompt_len for t in eng.timings] == list(lengths)


def test_pad_cache_leaves_the_cross_cache_at_n_frames():
    """whisper: prefill's k/v pad to max_seq, xk/xv stay at n_frames, by
    their specs (also where the prompt is as long as n_frames)."""
    cfg = reduced_config(ARCHS["whisper-large-v3"])
    m = build_model(cfg)
    eng = ServeEngine(m, m.init(torch.Generator().manual_seed(0)),
                      max_seq=MAX_SEQ, device="cpu")
    frames = torch.from_numpy(model_inputs(cfg, 1, 1)["frames"])
    prompt = list(range(1, cfg.n_frames + 1))          # len == n_frames
    _, cache = eng._prefill_one(prompt, {"frames": frames})
    kv = (cfg.n_layers, 1, MAX_SEQ, cfg.n_kv_heads, cfg.head_dim)
    cross = (cfg.n_layers, 1, cfg.n_frames, cfg.n_kv_heads, cfg.head_dim)
    assert {n: tuple(t.shape) for n, t in cache.items()} == {
        "k": kv, "v": kv, "xk": cross, "xv": cross}
    assert torch.count_nonzero(cache["k"][:, :, len(prompt):]) == 0
    assert torch.count_nonzero(cache["xk"]) == cache["xk"].numel()


@pytest.mark.parametrize("arch", ["whisper-large-v3", "paligemma-3b"])
def test_launcher_serves_the_vlm_and_audio_families(arch, capsys):
    """``launch.serve`` gives them zero frames or image rows, as the
    reference's launcher does, and serves on the CPU when asked."""
    from repro_torch.launch.serve import main
    assert main(["--arch", arch, "--reduced", "--device", "cpu",
                 "--requests", "1", "--prompt-len", "6", "--max-new",
                 "3"]) == 0
    assert "1 requests, 3 tokens" in capsys.readouterr().out
