"""Max errors of the PyTorch port against the JAX reference, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/torch_parity.py

Recomputes, at the sizes of the ``tests/test_torch_*.py`` parity tests, the
largest error each of them allows for, and prints a markdown table (test,
tolerance, max error seen).  Errors are absolute except where the tolerance
column says "of max" (absolute error over the reference tensor's largest
magnitude).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import reduced_config as j_reduced
from repro.kernels.flash_attention import flash_attention_bhsd as jax_flash
from repro.models import attention as ja
from repro.models import layers as jl
from repro.models.lm import build_model as j_build
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention as ta
from repro_torch.models import layers as tl
from repro_torch.models.convert import params_from_jax
from repro_torch.models.lm import build_model
from repro_torch.serve.engine import ServeEngine

GRID = [(128, 128, 4, 4, 64), (256, 256, 4, 1, 64), (128, 384, 8, 2, 32),
        (100, 200, 4, 2, 64)]


def err(got, want, rel=False):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    e = float(np.abs(got - want).max())
    return e / float(np.abs(want).max()) if rel else e


def flash_rows():
    rng = np.random.default_rng(0)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for sq, sk, h, kvh, d in GRID:
        xs = [rng.standard_normal(s, dtype=np.float32)
              for s in ((2, h, sq, d), (2, kvh, sk, d), (2, kvh, sk, d))]
        for dtype, jdt, tdt in (("float32", jnp.float32, torch.float32),
                                ("bfloat16", jnp.bfloat16, torch.bfloat16)):
            for causal in (True, False):
                want = jax_flash(*(jnp.asarray(x).astype(jdt) for x in xs),
                                 causal=causal, interpret=True)
                got = fa.flash_attention_bhsd(
                    *(torch.from_numpy(x).to(tdt) for x in xs), causal=causal)
                worst[dtype] = max(worst[dtype], err(got, want))
    return [("flash_attention_bhsd plain vs Pallas interpret, f32", "2e-5",
             worst["float32"]),
            ("flash_attention_bhsd plain vs Pallas interpret, bf16", "2e-2",
             worst["bfloat16"])]


def layer_rows():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64), dtype=np.float32) * 3
    p = {"scale": 1 + 0.1 * rng.standard_normal(64, dtype=np.float32),
         "bias": 0.1 * rng.standard_normal(64, dtype=np.float32)}
    rows = []
    for kind, keys in (("rms", ("scale",)), ("layer", ("scale", "bias"))):
        jp = {k: jnp.asarray(p[k]) for k in keys}
        tp = {k: torch.from_numpy(p[k]) for k in keys}
        rows.append((f"apply_norm {kind}", "1e-6",
                     err(tl.apply_norm(tp, torch.from_numpy(x)),
                         jl.apply_norm(jp, jnp.asarray(x)))))
    xr = rng.standard_normal((2, 7, 3, 32), dtype=np.float32)
    pos = (100 + np.arange(7))[None, :].repeat(2, 0)
    for frac in (0.5, 1.0):
        rows.append((f"apply_rope fraction {frac}", "1e-5 rel, 2e-6",
                     err(tl.apply_rope(torch.from_numpy(xr),
                                       torch.from_numpy(pos), frac, 1e4),
                         jl.apply_rope(jnp.asarray(xr), jnp.asarray(pos),
                                       frac, 1e4))))
    w = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("wi_gate", (32, 48)), ("wi_up", (32, 48)),
                      ("wo", (48, 32)))}
    xm = rng.standard_normal((2, 5, 32), dtype=np.float32)
    rows.append(("apply_mlp swiglu", "1e-5 rel, 1e-6",
                 err(tl.apply_mlp({k: torch.from_numpy(v) for k, v in w.items()},
                                  torch.from_numpy(xm), "swiglu"),
                     jl.apply_mlp({k: jnp.asarray(v) for k, v in w.items()},
                                  jnp.asarray(xm), "swiglu"))))
    return rows


def attention_rows():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 12, 8, 32), dtype=np.float32)
    k = rng.standard_normal((2, 40, 2, 32), dtype=np.float32)
    v = rng.standard_normal((2, 40, 2, 32), dtype=np.float32)
    J = [jnp.asarray(t) for t in (q, k, v)]
    T = [torch.from_numpy(t) for t in (q, k, v)]
    naive = max(err(ta.naive_attention(*T, causal=c, q_offset=o),
                    ja.naive_attention(*J, causal=c, q_offset=o))
                for c in (True, False) for o in (0, 7))
    blocked = max(err(ta.blocked_attention(*T, causal=c, q_offset=o, block=b),
                      ja.blocked_attention(*J, causal=c, q_offset=o, block=b))
                  for c in (True, False) for o in (0, 5) for b in (16, 64))
    ck, cv = T[1][:, :24], T[2][:, :24]
    dec = max(err(ta.decode_attention(T[0][:, :1], ck, cv, n),
                  ja.decode_attention(J[0][:, :1], J[1][:, :24], J[2][:, :24],
                                      jnp.asarray(n)))
              for n in (1, 9, 24))
    return [("naive_attention", "1e-5", naive),
            ("blocked_attention (q_offset, ragged Sk)", "1e-5", blocked),
            ("decode_attention, partly filled cache", "1e-5", dec)]


def lm_and_serve_rows():
    jcfg, tcfg = j_reduced(JARCHS["chatglm3-6b"]), reduced_config(
        ARCHS["chatglm3-6b"])
    rng = np.random.default_rng(0)
    tree = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape))
        .astype(np.float32), j_build(jcfg).init(jax.random.PRNGKey(0)))
    tp = params_from_jax(tree, tcfg, device="cpu")
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, size=(2, 13))
    rows = []
    for impl in ("flash", "blocked"):
        jm = j_build(jcfg, attn_impl=impl, kv_block=8)
        tm = build_model(tcfg, attn_impl=impl, kv_block=8)
        jlog, jc = jax.jit(jm.prefill_fn)(tree, {"tokens": toks})
        tlog, tc = tm.prefill_fn(tp, {"tokens": torch.from_numpy(toks)})
        pad = ((0, 0), (0, 0), (0, 3), (0, 0), (0, 0))
        jcache = {n: np.pad(np.asarray(jc[n]), pad) for n in ("k", "v")}
        tcache = {n: torch.from_numpy(jcache[n].copy()) for n in ("k", "v")}
        nxt = np.argmax(np.asarray(jlog), axis=-1)[:, None]
        jlog2, jc2 = jax.jit(jm.decode_fn)(
            tree, jcache, {"tokens": nxt, "pos": np.int32(13)})
        tlog2, tc2 = tm.decode_fn(tp, tcache, {"tokens": torch.from_numpy(nxt),
                                                "pos": 13})
        rows += [
            (f"reduced chatglm3-6b prefill logits, {impl}", "1e-4 of max",
             err(tlog, jlog, rel=True)),
            (f"reduced chatglm3-6b prefill cache k/v, {impl}", "1e-4 of max",
             max(err(tc[n], jc[n], rel=True) for n in ("k", "v"))),
            (f"reduced chatglm3-6b decode logits + cache, {impl}",
             "1e-4 of max",
             max([err(tlog2, jlog2, rel=True)]
                 + [err(tc2[n], jc2[n], rel=True) for n in ("k", "v")]))]
    jm, tm = j_build(jcfg, attn_impl="flash"), build_model(tcfg,
                                                           attn_impl="flash")
    mismatches = 0
    for max_seq, lengths in ((16, (2, 5, 11)), (24, (2,))):
        r = np.random.default_rng(max_seq)
        prompts = [[int(t) for t in r.integers(0, tcfg.vocab_size, size=n)]
                   for n in lengths]
        want = JServeEngine(jm, tree, max_seq=max_seq).generate(
            prompts, max_new_tokens=5)
        got = ServeEngine(tm, tp, max_seq=max_seq, device="cpu").generate(
            prompts, max_new_tokens=5)
        mismatches += sum(a != b for g, w in zip(got, want)
                          for a, b in zip(g, w))
    rows.append(("ServeEngine greedy tokens (mismatched tokens)", "exact",
                 mismatches))
    return rows


def main() -> int:
    rows = flash_rows() + layer_rows() + attention_rows() + lm_and_serve_rows()
    print("| test | tolerance | max error seen |")
    print("| --- | --- | --- |")
    for name, tol, e in rows:
        print(f"| {name} | {tol} | {e:.3g} |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
