"""Max errors of the PyTorch port against the JAX reference, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/torch_parity.py [group ...]

Recomputes, at the sizes of the ``tests/test_torch_*.py`` parity tests, the
largest error each of them allows for, and prints a markdown table (test,
tolerance, max error seen).  Errors are absolute except where the tolerance
column says "of max" (absolute error over the reference tensor's largest
magnitude) or "mixed" (|err| / (1 + |want|), which rtol = atol = tol holds
to tol).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import reduced_config as j_reduced
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_bhsd as jax_flash
from repro.kernels.ssd_scan import ssd_chunk_bwd_pallas, ssd_chunk_pallas
from repro.models import attention as ja
from repro.models import layers as jl
from repro.models import ssm as jssm
from repro.models.attention import quantize_kv as j_quantize_kv
from repro.models.lm import build_model as j_build
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.models import attention as ta
from repro_torch.models import layers as tl
from repro_torch.models import ssm as tssm
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


def err_mixed(got, want):
    """max |got - want| / (1 + |want|): the error that rtol = atol = tol
    allows up to tol."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float((np.abs(got - want) / (1 + np.abs(want))).max())


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


def _ssd_inputs(rng, B, L, H, P, N, G=None):
    """The reference kernel test's distributions; G groups for B/C when
    given, else head-broadcast (B, L, H, N)."""
    return (rng.standard_normal((B, L, H, P), dtype=np.float32),
            np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(np.float32),
            (-np.exp(0.5 * rng.standard_normal(H))).astype(np.float32),
            (0.5 * rng.standard_normal((B, L, G or H, N))).astype(np.float32),
            (0.5 * rng.standard_normal((B, L, G or H, N))).astype(np.float32))


def ssd_rows():
    rng = np.random.default_rng(3)
    chunk_err = 0.0
    for L, Q, H, P, N in ((64, 16, 2, 16, 16), (128, 32, 4, 32, 32),
                          (64, 32, 2, 16, 8), (48, 48, 3, 8, 16)):
        x, dt, A, Bm, Cm = _ssd_inputs(rng, 2, L, H, P, N)
        nc = L // Q
        xs = (x.reshape(2, nc, Q, H, P), dt.reshape(2, nc, Q, H), A,
              Bm.reshape(2, nc, Q, H, N), Cm.reshape(2, nc, Q, H, N))
        want = ssd_chunk_pallas(*(jnp.asarray(a) for a in xs), interpret=True)
        got = tssd.ssd_chunk(*(torch.from_numpy(np.ascontiguousarray(a))
                               for a in xs))
        chunk_err = max([chunk_err] + [err_mixed(g, w)
                                       for g, w in zip(got, want)])
    scan_ops = scan_ref = 0.0
    for L, H, P, N, chunk in ((64, 2, 16, 16, 16), (128, 4, 32, 32, 32),
                              (96, 2, 16, 8, 32)):
        xs = _ssd_inputs(rng, 2, L, H, P, N)
        got = tops.ssd_scan(*(torch.from_numpy(a) for a in xs), chunk=chunk)
        want = jops.ssd_scan(*(jnp.asarray(a) for a in xs), chunk=chunk)
        oracle = jref.ssd_ref(*(jnp.asarray(a) for a in xs))
        scan_ops = max([scan_ops] + [err_mixed(g, w)
                                     for g, w in zip(got, want)])
        scan_ref = max([scan_ref] + [err_mixed(g, w)
                                     for g, w in zip(got, oracle)])
    x, dt, A, Bm, Cm = (torch.from_numpy(a)
                        for a in _ssd_inputs(rng, 1, 64, 2, 16, 16))
    y, s = tops.ssd_scan(x, dt, A, Bm, Cm, chunk=16)
    y1, s1 = tops.ssd_scan(x[:, :40], dt[:, :40], A, Bm[:, :40], Cm[:, :40],
                           chunk=16)
    y2, s2 = tops.ssd_scan(x[:, 40:], dt[:, 40:], A, Bm[:, 40:], Cm[:, 40:],
                           chunk=16, initial_state=s1)
    split = max(err_mixed(torch.cat([y1, y2], 1), y.numpy()),
                err_mixed(s2, s.numpy()))
    return [("ssd_chunk plain vs Pallas interpret (y_diag, states, gamma)",
             "1e-5 mixed", chunk_err),
            ("ops.ssd_scan vs reference ops.ssd_scan (y, state)",
             "2e-3 mixed", scan_ops),
            ("ops.ssd_scan vs ref.ssd_ref (y, state)", "2e-3 mixed",
             scan_ref),
            ("ops.ssd_scan split at 40 with initial_state", "2e-3 mixed",
             split)]


def mamba_rows():
    rng = np.random.default_rng(4)
    rows = []
    u = rng.standard_normal((2, 7, 12), dtype=np.float32)
    w = rng.standard_normal((12, 4), dtype=np.float32) / 2
    b = rng.standard_normal(12, dtype=np.float32)
    c = rng.standard_normal((2, 3, 12), dtype=np.float32)
    conv = max(err(t, j)
               for cache in (None, c)
               for t, j in zip(
                   tssm.causal_conv(torch.from_numpy(u), torch.from_numpy(w),
                                    torch.from_numpy(b), None if cache is None
                                    else torch.from_numpy(cache)),
                   jssm.causal_conv(jnp.asarray(u), jnp.asarray(w),
                                    jnp.asarray(b), None if cache is None
                                    else jnp.asarray(cache))))
    rows.append(("causal_conv, with and without cache", "1e-5 of max", conv))
    chunked = 0.0
    for L, G, chunk in ((64, 1, 16), (50, 2, 16), (12, 1, 16)):
        xs = _ssd_inputs(rng, 2, L, 4, 8, 16, G=G)
        got = tssm.ssd_chunked(*(torch.from_numpy(a) for a in xs), chunk)
        want = jssm.ssd_chunked(*(jnp.asarray(a) for a in xs), chunk)
        chunked = max([chunked] + [err(g, w_, rel=True)
                                   for g, w_ in zip(got, want)])
    rows.append(("ssd_chunked (G 1 and 2, ragged L)", "1e-4 of max", chunked))
    args = (rng.standard_normal((2, 4, 8, 16), dtype=np.float32),
            rng.standard_normal((2, 4, 8), dtype=np.float32),
            np.log1p(np.exp(rng.standard_normal((2, 4)))).astype(np.float32),
            (-np.exp(0.5 * rng.standard_normal(4))).astype(np.float32),
            rng.standard_normal((2, 2, 16), dtype=np.float32),
            rng.standard_normal((2, 2, 16), dtype=np.float32))
    dec = max(err(g, w_, rel=True) for g, w_ in zip(
        tssm.ssd_decode_step(*(torch.from_numpy(a) for a in args)),
        jssm.ssd_decode_step(*(jnp.asarray(a) for a in args))))
    rows.append(("ssd_decode_step", "1e-5 of max", dec))
    x = rng.standard_normal((2, 5, 64), dtype=np.float32) * 3
    g = rng.standard_normal((2, 5, 64), dtype=np.float32)
    sc = 1 + 0.1 * rng.standard_normal(64, dtype=np.float32)
    rows.append(("rms_norm_gated", "1e-5 of max", err(
        tl.rms_norm_gated(torch.from_numpy(x), torch.from_numpy(sc),
                          torch.from_numpy(g)),
        jl.rms_norm_gated(jnp.asarray(x), jnp.asarray(sc), jnp.asarray(g)),
        rel=True)))
    return rows


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree}


def ssm_lm_rows():
    """Reduced mamba2/zamba2 LM prefill (logits + cache) and two decode
    steps against the reference, per impl; greedy ServeEngine tokens; and
    the reference's own jnp-vs-Pallas gap in bf16 (its init, 200 tokens)."""
    rows = []
    for arch in ("mamba2-1.3b", "zamba2-1.2b"):
        jcfg, tcfg = j_reduced(JARCHS[arch]), reduced_config(ARCHS[arch])
        rng = np.random.default_rng(0)
        tree = jax.tree.map(
            lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape))
            .astype(np.float32), j_build(jcfg).init(jax.random.PRNGKey(0)))
        tp = params_from_jax(tree, tcfg, device="cpu")
        toks = np.random.default_rng(1).integers(0, tcfg.vocab_size,
                                                 size=(2, 21))
        for impl, jimpl in (("chunked", "jnp"), ("kernel", "pallas")):
            jm = j_build(jcfg, attn_impl="flash", ssd_impl=jimpl)
            tm = build_model(tcfg, attn_impl="flash", ssd_impl=impl)
            jlog, jc = jax.jit(jm.prefill_fn)(tree, {"tokens": toks})
            tlog, tc = tm.prefill_fn(tp, {"tokens": torch.from_numpy(toks)})
            jf, tf = _flat(jc), _flat(tc)
            pre = max([err(tlog, jlog, rel=True)]
                      + [err(tf[n], jf[n], rel=True) for n in jf])
            grow = {n: np.pad(np.asarray(a), ((0, 0), (0, 0), (0, 3), (0, 0),
                                              (0, 0)))
                    if n.startswith("shared_") else np.asarray(a)
                    for n, a in jf.items()}

            def nest(flat):
                out = {}
                for n, a in flat.items():
                    *path, leaf = n.split("/")
                    d = out
                    for k in path:
                        d = d.setdefault(k, {})
                    d[leaf] = a
                return out

            jcache = nest(grow)
            tcache = nest({n: torch.from_numpy(a.copy())
                           for n, a in grow.items()})
            nxt = np.argmax(np.asarray(jlog), axis=-1)[:, None]
            dec = 0.0
            for pos in (21, 22):
                jlog2, jcache = jax.jit(jm.decode_fn)(
                    tree, jcache, {"tokens": nxt, "pos": np.int32(pos)})
                tlog2, tcache = tm.decode_fn(
                    tp, tcache, {"tokens": torch.from_numpy(nxt), "pos": pos})
                jf2, tf2 = _flat(jcache), _flat(tcache)
                dec = max([dec, err(tlog2, jlog2, rel=True)]
                          + [err(tf2[n], jf2[n], rel=True) for n in jf2])
                nxt = np.argmax(np.asarray(jlog2), axis=-1)[:, None]
            r = np.random.default_rng(2)
            prompts = [[int(t) for t in r.integers(0, tcfg.vocab_size, size=n)]
                       for n in (4, 17, 33)]
            want = JServeEngine(jm, tree, max_seq=40).generate(
                prompts, max_new_tokens=5)
            got = ServeEngine(tm, tp, max_seq=40, device="cpu").generate(
                prompts, max_new_tokens=5)
            mism = sum(a != b for g, w in zip(got, want) for a, b in zip(g, w))
            rows += [
                (f"reduced {arch} prefill logits + cache, {impl}",
                 "1e-4 of max", pre),
                (f"reduced {arch} 2 decode steps, logits + cache, {impl}",
                 "1e-4 of max", dec),
                (f"reduced {arch} ServeEngine greedy tokens, {impl} "
                 "(mismatched tokens)", "exact", mism)]
        p = j_build(jcfg).init(jax.random.PRNGKey(0), dtype=jnp.bfloat16)
        toks = np.random.default_rng(0).integers(0, jcfg.vocab_size,
                                                 size=(1, 200))
        logits = {impl: np.asarray(jax.jit(j_build(
            jcfg, ssd_impl=impl, attn_impl="flash").prefill_fn)(
                p, {"tokens": toks})[0], np.float32)
            for impl in ("jnp", "pallas")}
        rows.append((f"reference only: reduced {arch} bf16 prefill logits, "
                     "jnp vs pallas", "none (a measurement)",
                     err(logits["pallas"], logits["jnp"], rel=True)))
    return rows


# ------------------------------------------------------------ slice 3
def ssd_bwd_rows():
    """K5's plain version against the Pallas backward; gradients of
    ops.ssd_scan against jax.grad of the reference's and of ssd_ref;
    apply_mamba through the kernel path against the chunked one."""
    rng = np.random.default_rng(5)
    bwd = 0.0
    for B, L, H, P, N, Q in ((2, 64, 2, 16, 16, 16), (2, 128, 4, 32, 32, 32),
                             (2, 64, 2, 16, 8, 32), (1, 48, 3, 8, 16, 48),
                             (1, 40, 2, 16, 8, 40)):
        nc = L // Q
        ch = [a.reshape(B, nc, Q, *a.shape[2:]) if a.ndim > 1 else a
              for a in _ssd_inputs(rng, B, L, H, P, N)]
        cot = (rng.standard_normal((B, nc, Q, H, P), dtype=np.float32),
               rng.standard_normal((B, nc, H, N, P), dtype=np.float32),
               rng.standard_normal((B, nc, H), dtype=np.float32))

        def flat(a):
            a = np.moveaxis(a, 3, 2)
            return a.reshape(B, nc * H, Q, *a.shape[4:])

        want = ssd_chunk_bwd_pallas(
            jnp.asarray(flat(ch[0])), jnp.asarray(flat(ch[1][..., None])[..., 0]),
            jnp.asarray(np.tile(ch[2], nc)), jnp.asarray(flat(ch[3])),
            jnp.asarray(flat(ch[4])), jnp.asarray(flat(cot[0])),
            jnp.asarray(cot[1].reshape(B, nc * H, N, P)),
            jnp.asarray(cot[2].reshape(B, nc * H)), interpret=True)
        got = tssd.ssd_chunk_bwd(*(torch.from_numpy(np.ascontiguousarray(a))
                                   for a in (*ch, *cot)))
        for g, w in zip(got[:4], want[:4]):
            g = np.moveaxis(g.numpy(), 3, 2).reshape(np.asarray(w).shape)
            bwd = max(bwd, err_mixed(g, w))
        bwd = max(bwd, err_mixed(got[4].reshape(B, nc * H), want[4]))

    grad_ops = grad_ref = 0.0
    for B, L, H, P, N, chunk in ((2, 64, 2, 16, 16, 16), (2, 128, 4, 32, 32, 32),
                                 (2, 96, 2, 16, 8, 32), (1, 48, 3, 8, 16, 48),
                                 (1, 100, 2, 16, 8, 80)):
        xs = _ssd_inputs(rng, B, L, H, P, N, G=1)
        cot = (rng.standard_normal((B, L, H, P), dtype=np.float32),
               rng.standard_normal((B, H, P, N), dtype=np.float32))
        for s0 in (None, rng.standard_normal((B, H, P, N), dtype=np.float32)):
            ts = [torch.from_numpy(a).requires_grad_(True) for a in xs]
            init = None if s0 is None else torch.from_numpy(s0).requires_grad_(True)
            y, s = tops.ssd_scan(*ts[:3], *(t.expand(-1, -1, H, -1) for t in ts[3:]),
                                 chunk=chunk, initial_state=init)
            ((y * torch.from_numpy(cot[0])).sum()
             + (s * torch.from_numpy(cot[1])).sum()).backward()
            got = [t.grad for t in ts] + ([] if init is None else [init.grad])

            def jgrads(fn):
                def loss(*args):
                    bh, chh = (jnp.broadcast_to(t, t.shape[:2] + (H, N))
                               for t in args[3:5])
                    yy, ss = fn(*args[:3], bh, chh,
                                args[5] if len(args) > 5 else None)
                    return (yy * cot[0]).sum() + (ss * cot[1]).sum()
                args = [jnp.asarray(a) for a in xs] + (
                    [] if s0 is None else [jnp.asarray(s0)])
                return jax.grad(loss, argnums=tuple(range(len(args))))(*args)

            w_ops = jgrads(lambda x, dt, A, b, c, i: jops.ssd_scan(
                x, dt, A, b, c, chunk=chunk, initial_state=i))
            w_ref = jgrads(lambda x, dt, A, b, c, i: jref.ssd_ref(
                x, dt, A, b, c, initial_state=i))
            grad_ops = max([grad_ops] + [err_mixed(g, w)
                                         for g, w in zip(got, w_ops)])
            grad_ref = max([grad_ref] + [err_mixed(g, w)
                                         for g, w in zip(got, w_ref)])

    mamba = 0.0
    for arch in ("mamba2-1.3b", "zamba2-1.2b"):
        cfg = reduced_config(ARCHS[arch])
        params = build_model(cfg).init(torch.Generator().manual_seed(0))
        lp = {k: v[0].clone().requires_grad_(True)
              for k, v in params["layers"]["mamba"].items()}
        x_in = torch.from_numpy(np.random.default_rng(7).standard_normal(
            (2, 40, cfg.d_model), dtype=np.float32))
        out = {}
        for impl in ("chunked", "kernel"):
            y, _ = tssm.apply_mamba(lp, x_in, cfg, mode="train", impl=impl)
            out[impl] = (y, torch.autograd.grad((y * y).sum(), list(lp.values())))
        mamba = max([mamba, err_mixed(out["kernel"][0], out["chunked"][0]
                                      .detach().numpy())]
                    + [err_mixed(g, w.numpy()) for g, w in
                       zip(out["kernel"][1], out["chunked"][1])])
    return [("ssd_chunk_bwd plain vs Pallas interpret (dx, ddt, dB, dC, da)",
             "1e-4 mixed", bwd),
            ("grads of ops.ssd_scan (B/C broadcast, with and without "
             "initial_state) vs jax.grad of reference ops.ssd_scan",
             "2e-4 mixed", grad_ops),
            ("the same vs jax.grad of ref.ssd_ref", "2e-4 mixed", grad_ref),
            ("apply_mamba train, kernel vs chunked, output and parameter "
             "grads (reduced mamba2, zamba2)", "5e-3 mixed", mamba)]


def train_part_rows():
    from repro.data.synthetic import SyntheticLMDataset as JDataset
    from repro.models.layers import next_token_loss as j_ntl
    from repro.train import optimizer as jopt
    from repro.train import schedule as jsched
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.models.layers import next_token_loss
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as topt
    from repro_torch.train import schedule as tsched

    mism = 0
    for seed, vocab, seq, batch in ((0, 512, 64, 4), (3, 50280, 33, 3),
                                    (7, 65024, 128, 2)):
        for step in (0, 1, 17):
            mism += int(np.sum(
                SyntheticLMDataset(vocab, seq, batch, seed=seed).batch(step)
                ["tokens"] != JDataset(vocab, seq, batch, seed=seed)
                .batch(step)["tokens"]))
    sched = 0.0
    for name in ("constant", "linear", "cosine", "rsqrt"):
        kw = dict(name=name, base_lr=3e-4, warmup_steps=10, total_steps=100)
        pt = tsched.make_schedule(tsched.ScheduleConfig(**kw))
        jt = jsched.make_schedule(jsched.ScheduleConfig(**kw))
        sched = max([sched] + [err_mixed(pt(s), np.asarray(jt(s)))
                               for s in (0, 1, 5, 9, 10, 11, 50, 99, 100, 250)])
    rng = np.random.default_rng(0)
    shapes = {"w": (2, 128, 160), "b": (160,), "e": {"t": (130, 128)}, "s": (3,)}
    draw = lambda sc: jax.tree.map(  # noqa: E731
        lambda s: (sc * rng.standard_normal(s)).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    params, grads = draw(0.1), draw(0.01)
    tt = lambda t: jax.tree.map(lambda a: torch.from_numpy(np.array(a)), t)  # noqa: E731
    opt_rows = []
    for name in ("adamw", "adafactor"):
        ji, ju, _ = jopt.make_optimizer(name)
        ti, tu, _ = topt.make_optimizer(name)
        jp = jax.tree.map(jnp.asarray, params)
        js, tp = ji(jp), tt(params)
        ts = ti(tp)
        for _ in range(2):
            jp, js = ju(jax.tree.map(jnp.asarray, grads), js, jp, 3e-4)
            tp, ts = tu(tt(grads), ts, tp, 3e-4)
        e = max(err_mixed(g, np.asarray(w)) for g, w in
                zip(ckpt.flatten((tp, ts)), jax.tree.leaves((jp, js))))
        opt_rows.append((f"{name}: two updates, parameters and state",
                         "1e-6 mixed", e))
    logits = rng.standard_normal((2, 17, 96)).astype(np.float32) * 3
    toks = rng.integers(0, 80, size=(2, 17))
    ntl = err_mixed(next_token_loss(torch.from_numpy(logits),
                                    torch.from_numpy(toks), 80),
                    np.asarray(j_ntl(jnp.asarray(logits), jnp.asarray(toks), 80)))
    return [("synthetic batches (mismatched tokens)", "exact", mism),
            ("schedules (4 kinds, 10 steps)", "1e-6 mixed", sched),
            *opt_rows,
            ("next_token_loss with padded vocab", "1e-6 mixed", ntl)]


def train_step_rows():
    """Two train steps of each case from the same state in both packages;
    AdamW-amplified elements counted apart (tests/test_torch_train.py); and
    the chained second step's grad_norm gap."""
    from repro.configs import RunConfig as JRun
    from repro.configs import ShapeConfig as JShape
    from repro.data.synthetic import SyntheticLMDataset as JDataset
    from repro.train.trainer import make_train_step as j_mts
    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.models.convert import params_to_numpy
    from repro_torch.train.optimizer import AdamWState
    from repro_torch.train.trainer import make_train_step

    metric = params_err = chained = 0.0
    amplified, amp_lr = 0, 0.0
    for arch, impl, jimpl in (("chatglm3-6b", "chunked", "jnp"),
                              ("mamba2-1.3b", "chunked", "jnp"),
                              ("mamba2-1.3b", "kernel", "pallas"),
                              ("zamba2-1.2b", "kernel", "pallas")):
        for mb in (0, 1):
            kw = dict(microbatch=mb, param_dtype="float32",
                      compute_dtype="float32")
            jcfg, tcfg = j_reduced(JARCHS[arch]), reduced_config(ARCHS[arch])
            jrun = JRun(model=jcfg, shape=JShape("t", 32, 2, "train"), **kw)
            trun = RunConfig(model=tcfg, shape=ShapeConfig("t", 32, 2, "train"),
                             **kw)
            r = np.random.default_rng(0)
            tree = jax.tree.map(
                lambda a: (np.asarray(a) + 0.05 * r.standard_normal(a.shape))
                .astype(np.float32), j_build(jcfg).init(jax.random.PRNGKey(0)))
            ds = JDataset(jcfg.vocab_size, 32, 2, seed=3)
            jmodel = j_build(jcfg, ssd_impl=jimpl)
            jstep, *_, jinit = j_mts(jmodel, jrun, None)
            jstep = jax.jit(jstep)
            jgrad = jax.jit(jax.grad(   # the reference's: decides amplified
                lambda p, t: jmodel.loss_fn(p, {"tokens": t})[0]))
            tmodel = build_model(tcfg, ssd_impl=impl)
            tstep, *_, tinit = make_train_step(tmodel, trun)
            jp = jax.tree.map(jnp.asarray, tree)
            jo = jinit(jp)
            cp = params_from_jax(tree, tcfg, device="cpu")
            co = tinit(cp)
            conv = lambda t: params_from_jax(  # noqa: E731
                jax.tree.map(np.asarray, t), tcfg, device="cpu")
            for i in range(2):
                toks = ds.batch(i)["tokens"]
                tb = {"tokens": torch.from_numpy(toks).long()}
                p_in = jax.tree.map(np.asarray, jp)
                tp, _, tm = tstep(conv(jp), AdamWState(
                    torch.tensor(int(jo.step), dtype=torch.int32),
                    conv(jo.mu), conv(jo.nu)), tb)
                g = _flat(jgrad(p_in, jnp.asarray(toks)))
                cp, co, cm = tstep(cp, co, tb)           # the port alone
                jp, jo, jm = jstep(jp, jo, {"tokens": jnp.asarray(toks)})
                metric = max(metric, err_mixed(tm["loss"], np.asarray(jm["loss"])),
                             err_mixed(tm["grad_norm"], np.asarray(jm["grad_norm"])))
                if i == 1:
                    chained = max(chained, abs(float(cm["grad_norm"])
                                               / float(jm["grad_norm"]) - 1))
                got, want = _flat(params_to_numpy(tp)), _flat(jp)
                for k in want:
                    w = np.asarray(want[k])
                    d = np.abs(got[k] - w)
                    out = d > 1e-4 * (1 + np.abs(w))
                    gk = np.abs(g[k])
                    amp = out & (gk < 1e-2 * np.median(gk[gk > 0]))
                    amplified += int(amp.sum())
                    if amp.any():
                        amp_lr = max(amp_lr, float(d[amp].max()) / 3e-4)
                    params_err = max(params_err,
                                     float((d / (1 + np.abs(w)))[~amp].max()))
    return [("train step, 4 models x microbatch 1, 2, two steps from the same "
             "state: loss, grad_norm", "1e-4 mixed", metric),
            ("the same, every parameter but AdamW-amplified elements",
             "1e-4 mixed", params_err),
            ("the same, AdamW-amplified elements (count)",
             "none (|g| < 1e-2 median)", amplified),
            ("the same, largest move apart of an amplified element, in lr",
             "2", amp_lr),
            ("chained: the port's own second step, grad_norm relative gap",
             "none (a measurement)", chained)]


def train_loop_rows():
    import tempfile

    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.launch import train as ltrain
    from repro_torch.train import fault
    cfg = reduced_config(ARCHS["mamba2-1.3b"])
    run = RunConfig(model=cfg, shape=ShapeConfig("t", 32, 2, "train"),
                    param_dtype="float32", compute_dtype="float32")
    model = build_model(cfg, ssd_impl="kernel")
    clean = ltrain.train_loop(model, run, n_steps=5, device="cpu", log_every=99)
    with tempfile.TemporaryDirectory() as d:
        hit = ltrain.train_loop(model, run, n_steps=5, ckpt_dir=d, ckpt_every=2,
                                injector=fault.FaultInjector(fail_at_steps=(3,)),
                                device="cpu", log_every=99)
    gap = max(abs(a - b) for a, b in zip(hit.losses[:3] + hit.losses[3:],
                                          clean.losses[:3] + clean.losses[2:]))
    return [("train_loop with a fault at step 3 vs without: losses", "exact",
             gap)]


GOLDEN_HLO = """
HloModule chain, num_partitions=1

ENTRY %main (p0: f32[4096,4096]) -> f32[4096,4096] {
  %p0 = f32[4096,4096] parameter(0)
  %dot = f32[4096,4096] dot(%p0, %p0), lhs_contracting_dims={1}
  %e = f32[4096,4096] exponential(%dot)
  %dot2 = f32[4096,4096] dot(%e, %e), lhs_contracting_dims={1}
  ROOT %neg = f32[4096,4096] negate(%dot2)
}
"""


def _k1_inputs(name, n, seed):
    from repro.kernels.stream import EXPRS
    fn, n_in, din, dout = EXPRS[name]
    dt = {"f8": np.float64, "f4": np.float32, "i4": np.int32}
    rng = np.random.default_rng(seed)
    x1 = (rng.integers(-1000, 1000, n).astype(np.int32) if din == "i4" else
          (np.abs(rng.standard_normal(n)) + 0.5).astype(dt[din]))
    x2 = (np.abs(rng.standard_normal(n)) + 0.5).astype(
        dt["f8" if din == "i4" else din])
    return x1, x2, np.zeros(n, dt[dout])


def _k1_hlo(name, n):
    from repro.kernels.stream import EXPRS
    with jax.enable_x64(True):
        x1, x2, y0 = (jnp.asarray(a) for a in _k1_inputs(name, n, 0))
        f = jax.jit(lambda a, b, y: jref.elementwise_ref(name, a, b, y))
        return f.lower(x1, x2, y0).compile().as_text()


def slice4_rows():
    """Slice 4: the simulator core, K1/K2's plain versions, kernel_program."""
    import dataclasses
    import json

    from repro.core import hlo as rh
    from repro.core import hwspec as rhw
    from repro.core import simulate as rsim
    from repro.kernels import stream as jstream
    from repro_torch.core import calibrate as tcal
    from repro_torch.core import hlo as th
    from repro_torch.core import hwspec as thw
    from repro_torch.core import simulate as tsim
    from repro_torch.kernels import stream as tstream

    def report(mod, text, hw):
        rep = mod.simulate(text, hw=hw, compute_dtype="f32", engine="both")
        d = json.loads(rep.to_json())
        return rep.pa, {k: v for k, v in d.items()
                        if k not in ("xla_cost_analysis", "memory_analysis")}

    texts = [GOLDEN_HLO] + [_k1_hlo(k, 4096) for k in jstream.EXPRS]
    differ = 0
    for text in texts:
        for spec in ("tpu_v5e", "a64fx_core", "cpu_host"):
            differ += dataclasses.asdict(th.parse_program(text)) \
                != dataclasses.asdict(rh.parse_program(text))
            differ += report(tsim, text, thw.SPECS[spec]) \
                != report(rsim, text, rhw.SPECS[spec])
    k1, k2 = 0.0, {}
    for name in jstream.EXPRS:
        for n, block in ((4096, 512), (3 * 4096, 4096)):
            x1, x2, y0 = _k1_inputs(name, n, n + len(name))
            with jax.enable_x64(True):
                want = np.asarray(jstream.elementwise(
                    name, *(jnp.asarray(a) for a in (x1, x2, y0)),
                    block=block, interpret=True), np.float64)
            got = tstream.elementwise_plain(
                name, *(torch.from_numpy(a) for a in (x1, x2, y0)))
            k1 = max(k1, float((np.abs(got.double().numpy() - want)
                                / (1 + np.abs(want))).max()))
    for dtype in (np.float32, np.float64):
        rng = np.random.default_rng(0)
        a, b = (rng.standard_normal(1 << 14).astype(dtype) for _ in range(2))
        with jax.enable_x64(True):
            want = np.asarray(jstream.stream_triad(
                jnp.asarray(a), jnp.asarray(b), 3.0, block=4096,
                interpret=True))
        got = tstream.stream_triad_plain(torch.from_numpy(a),
                                         torch.from_numpy(b)).numpy()
        k2[dtype] = float(np.abs(got - want).max())
    mism = 0
    for name in jstream.EXPRS:
        if name in ("mod", "aint", "sign"):     # test_torch_kernel_program.py
            continue
        ref = rh.parse_program(_k1_hlo(name, 4096))
        prog = tcal.kernel_program(name, 4096)
        vpu = {k: v for k, v in ref.ops[0].vpu_by_opcode.items()
               if k != "broadcast"}
        mism += (prog.bytes_accessed != ref.bytes_accessed
                 or prog.ops[0].trans_by_opcode != ref.ops[0].trans_by_opcode
                 or prog.ops[0].vpu_by_opcode != vpu)
    return [
        (f"core: Program, SimReport.to_json() (both engines) and PA text "
         f"under 3 "
         f"specs, {len(texts)} HLO texts (golden chain + 28 Table-1 "
         f"kernels); fields that differ", "exact", differ),
        ("K1 elementwise_plain vs Pallas interpret, 28 expressions x 2 sizes",
         "1e-12 mixed", k1),
        ("K2 stream_triad_plain vs Pallas interpret, f32 / f64 (absolute)",
         "1e-5 rel + 1e-6 / 1e-12", max(k2.values())),
        ("kernel_program vs reference parse, 25 kernels outside the three "
         "named exceptions (bytes, trans, vpu without broadcast); kernels "
         "that differ", "exact", mism)]


def _perturbed(cfg, seed=0):
    """The reference's init plus seeded noise, as a numpy tree (the
    families' parity tests' parameters, ``tests/_families.py``)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape))
        .astype(np.float32), j_build(cfg).init(jax.random.PRNGKey(seed)))


def _family_inputs(cfg, batch, seq, seed=1):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, size=(batch, seq))}
    if cfg.family == "vlm":
        out["img_embeds"] = rng.standard_normal(
            (batch, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (batch, cfg.n_frames, cfg.d_model)).astype(np.float32)
    return out


def family_rows():
    """The PR-20 families at reduced width, as
    ``tests/test_torch_lm_families.py`` and ``test_torch_kv_int8.py`` hold
    them: llama4-scout-17b-a16e (MoE), paligemma-3b (vlm) and
    whisper-large-v3 (audio, cross-attention) prefill (logits and caches)
    and three decode steps (logits and the caches after them), both
    attention paths; qwen1.5-32b's three decode steps over the int8 KV
    cache filled from the reference's prefill (logits; the int8 values and
    the f16 scales after them)."""
    B, S, steps = 2, 13, 3
    rows = []
    for arch, kind in (("llama4-scout-17b-a16e", "moe"),
                       ("paligemma-3b", "vlm"),
                       ("whisper-large-v3", "audio, cross-attention")):
        jcfg, tcfg = j_reduced(JARCHS[arch]), reduced_config(ARCHS[arch])
        tree = _perturbed(jcfg)
        tp = params_from_jax(tree, tcfg, device="cpu")
        batch = _family_inputs(tcfg, B, S)
        tbatch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
        names = ["k", "v", "xk", "xv"] if tcfg.family == "audio" \
            else ["k", "v"]
        pre = dec = 0.0
        for impl in ("flash", "blocked"):
            jm = j_build(jcfg, attn_impl=impl, kv_block=8)
            tm = build_model(tcfg, attn_impl=impl, kv_block=8)
            jlog, jc = jax.jit(jm.prefill_fn)(tree, batch)
            tlog, tc = tm.prefill_fn(tp, tbatch)
            pre = max([pre, err(tlog, jlog, rel=True)]
                      + [err(tc[n], jc[n], rel=True) for n in names])
            pad = ((0, 0), (0, 0), (0, steps), (0, 0), (0, 0))
            jcache = {n: np.pad(np.asarray(jc[n]), pad) if n in ("k", "v")
                      else np.asarray(jc[n]) for n in names}
            tcache = {n: torch.from_numpy(a.copy()) for n, a in jcache.items()}
            decode = jax.jit(jm.decode_fn)
            nxt = np.argmax(np.asarray(jlog), axis=-1)[:, None]
            for i in range(steps):
                jl2, jcache = decode(tree, jcache,
                                     {"tokens": nxt, "pos": np.int32(S + i)})
                tl2, tcache = tm.decode_fn(tp, tcache, {
                    "tokens": torch.from_numpy(nxt), "pos": S + i})
                dec = max(dec, err(tl2, jl2, rel=True))
                nxt = np.argmax(np.asarray(jl2), axis=-1)[:, None]
            dec = max([dec] + [err(tcache[n], jcache[n], rel=True)
                               for n in names])
        rows += [(f"{arch} ({kind}) prefill, logits and caches, flash and "
                  f"blocked", "1e-4 of max", pre),
                 (f"{arch} ({kind}) {steps} decode steps, logits and caches",
                  "1e-4 of max", dec)]

    arch, smax = "qwen1.5-32b", 16
    B, S = 2, 11
    jcfg, tcfg = j_reduced(JARCHS[arch]), reduced_config(ARCHS[arch])
    tree = _perturbed(jcfg)
    tp = params_from_jax(tree, tcfg, device="cpu")
    jm = j_build(jcfg, kv_cache_dtype="int8")
    tm = build_model(tcfg, kv_cache_dtype="int8")
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, size=(B, S))
    jlog, jc = jax.jit(jm.prefill_fn)(tree, {"tokens": toks})
    cache = {n: np.array(a) for n, a in jm.init_cache(B, smax).items()}
    for name in ("k", "v"):
        qv, sc = jax.jit(j_quantize_kv)(jc[name])
        cache[name][:, :, :S] = np.asarray(qv)
        cache[f"{name}_scale"][:, :, :S] = np.asarray(sc)
    tcache = tm.init_cache(B, smax, device="cpu")
    for n, a in cache.items():
        tcache[n].copy_(torch.from_numpy(a))
    decode, jcache = jax.jit(jm.decode_fn), cache
    nxt = np.argmax(np.asarray(jlog), axis=-1)[:, None]
    logits = 0.0
    for i in range(steps):
        jl2, jcache = decode(tree, jcache, {"tokens": nxt,
                                            "pos": np.int32(S + i)})
        tl2, tcache = tm.decode_fn(tp, tcache, {
            "tokens": torch.from_numpy(nxt), "pos": S + i})
        logits = max(logits, err(tl2, jl2, rel=True))
        nxt = np.argmax(np.asarray(jl2), axis=-1)[:, None]
    q8 = max(err(tcache[n], jcache[n]) for n in ("k", "v"))
    scales = max(err(tcache[n], jcache[n], rel=True)
                 for n in ("k_scale", "v_scale"))
    rows += [(f"{arch} int8 KV cache, {steps} decode steps, logits",
              "1e-4 of max", logits),
             (f"{arch} int8 KV cache after the steps, int8 values",
              "1 (a value at a rounding half)", q8),
             (f"{arch} int8 KV cache after the steps, f16 scales",
              "1e-3 of max", scales)]
    return rows


GROUPS = {"flash": flash_rows, "layers": layer_rows,
          "attention": attention_rows, "lm_serve": lm_and_serve_rows,
          "ssd": ssd_rows, "mamba": mamba_rows, "ssm_lm": ssm_lm_rows,
          "ssd_bwd": ssd_bwd_rows, "train_parts": train_part_rows,
          "train_step": train_step_rows, "train_loop": train_loop_rows,
          "slice4": slice4_rows, "families": family_rows}


def main(argv=None) -> int:
    """Print the table; ``argv`` names groups of rows (default: all)."""
    import sys
    names = (sys.argv[1:] if argv is None else argv) or list(GROUPS)
    torch.set_num_threads(1)
    rows = [row for name in names for row in GROUPS[name]()]
    print("| test | tolerance | max error seen |")
    print("| --- | --- | --- |")
    for name, tol, e in rows:
        print(f"| {name} | {tol} | {e:.3g} |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
