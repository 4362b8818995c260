"""One reduced step in both packages, as the simulator's ``Program``.

The reference's step is compiled by XLA:CPU and parsed by
``repro.core.hlo.parse_program``; the port's is captured by
``repro_torch.core.aten.capture`` and parsed by ``aten.parse_graph``.  Both
start from the same numpy parameter tree (the reference's init, carried
over by ``models.convert``), in f32, at batch 4 and 64 tokens (with zero
image embeddings or frames for the vlm and audio families); the SSD scan
runs the reference's ``jnp`` path and the port's ``chunked`` one, attention
``blocked`` in the training steps and the models' default in the prefills.
Used by ``test_torch_aten*.py`` and ``tools/aten_parity.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import RunConfig as JRunConfig
from repro.configs import ShapeConfig as JShapeConfig
from repro.configs import reduced_config as j_reduced
from repro.core.hlo import parse_program
from repro.models.lm import build_model as j_build
from repro.train.trainer import make_train_step as j_make_train_step
from repro_torch.configs import ARCHS, RunConfig, ShapeConfig, reduced_config
from repro_torch.core import aten
from repro_torch.models.convert import params_from_jax
from repro_torch.models.lm import build_model
from repro_torch.train.trainer import make_train_step

B, S = 4, 64
KW = dict(param_dtype="float32", compute_dtype="float32")


def programs(arch: str, what: str):
    """(reference Program, port Program, port GraphModule) of ``arch``'s
    ``what`` ("train" or "prefill") step."""
    jcfg, tcfg = j_reduced(JARCHS[arch]), reduced_config(ARCHS[arch])
    jm = j_build(jcfg, ssd_impl="jnp")
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (B, S))
    jbatch = {"tokens": jnp.asarray(toks, jnp.int32)}
    tm = build_model(tcfg, ssd_impl="chunked")
    tp = params_from_jax(tree, tcfg, device="cpu")
    tbatch = {"tokens": torch.from_numpy(toks).long()}
    # the vlm and audio inputs, zeros in both (as the launchers pass them)
    for name, spec in tm.input_specs(ShapeConfig("t", S, B, what)).items():
        if name != "tokens":
            jbatch[name] = jnp.zeros(spec.shape, jnp.float32)
            tbatch[name] = torch.zeros(spec.shape)
    if what == "train":
        jrun = JRunConfig(model=jcfg, shape=JShapeConfig("t", S, B, "train"),
                          **KW)
        jstep, *_, jopt_init = j_make_train_step(jm, jrun, None)
        jp = jax.tree.map(jnp.asarray, tree)
        text = jax.jit(jstep).lower(jp, jopt_init(jp), jbatch).compile() \
            .as_text()
        trun = RunConfig(model=tcfg, shape=ShapeConfig("t", S, B, "train"),
                         **KW)
        step, *_, opt_init = make_train_step(tm, trun)
        gm = aten.capture(step, tp, opt_init(tp), tbatch)
    else:
        text = jax.jit(jm.prefill_fn).lower(tree, jbatch).compile().as_text()

        def prefill(params, batch):
            with torch.no_grad():
                return tm.prefill_fn(params, batch)
        gm = aten.capture(prefill, tp, tbatch)
    return parse_program(text), aten.parse_graph(gm), gm


def reckoned_matmul_gap(arch: str, what: str) -> float:
    """The port's matmul-class FLOPs less the reference's, reckoned from the
    shapes.  The only einsum the two SSD formulations write differently is
    the chunk states'.  The reference contracts three operands,
    ``einsum("bcjh,bcjhn,bcjhp->bchpn", decay, B, x)``, and the gradient of
    its decay factor comes out of a dot over the state dim N: 2 B L H N
    FLOPs in each Mamba2 layer.  The port multiplies decay into B
    elementwise first, so that gradient is a multiply and a sum, no dot.
    The forward and prefill dots are the same in both."""
    cfg = reduced_config(ARCHS[arch])
    if cfg.family not in ("ssm", "hybrid") or what != "train":
        return 0.0
    s = cfg.ssm
    L = -(-S // s.chunk) * s.chunk
    return -float(cfg.n_layers * 2 * B * L * s.n_heads(cfg.d_model)
                  * s.d_state)
