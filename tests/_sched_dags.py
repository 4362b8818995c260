"""Random DAG programs and O3 knobs for the schedulers' differential tests.

A copy of ``random_program``/``random_knobs`` of
``tests/test_compiled_schedule.py`` (that file imports
``repro.core.calibrate``, which fails at import under jax 0.9), with the
package to build from passed in: ``hlo`` is ``repro.core.hlo`` or
``repro_torch.core.hlo``, ``hw`` its ``hwspec``.  The same ``random.Random``
state gives the same program in both packages.
"""
import random

PORTS4 = ("mxu", "vpu", "mem", "ici")


def random_program(rng: random.Random, n: int, hlo):
    """Random DAG with the op mix the cost model actually charges."""
    ops = []
    for i in range(n):
        k = min(i, rng.randint(0, 3))
        deps = sorted(rng.sample(range(i), k))
        cls = rng.choice(["elementwise", "data", "matmul", "reduce",
                          "transcendental", "unknown-class"])
        ops.append(hlo.OpStat(
            f"op{i}", "fusion", cls, "f32",
            flops=rng.uniform(1e3, 1e9),
            transcendentals=rng.uniform(0, 1e3),
            bytes_accessed=rng.uniform(1e3, 1e8),
            read_bytes=rng.uniform(1e3, 5e7),
            write_bytes=rng.uniform(0, 5e7),
            count=rng.choice([1.0, 1.0, 4.0]),
            deps=deps, dep_bytes=[rng.uniform(0, 1e6) for _ in deps]))
    return hlo.Program(ops=ops, entry="e", n_partitions=1)


def random_knobs(rng: random.Random, hw):
    base = rng.choice([hw.TPU_V5E, hw.CPU_HOST, hw.A64FX_CORE])
    return base.with_(
        inflight_window=rng.choice([1, 2, 7, 64, 1024]),
        issue_width={p: rng.randint(1, 4) for p in PORTS4},
        queue_depth={p: rng.randint(1, 32) for p in PORTS4})


def both_programs(seed: int, n: int, ref_hlo, port_hlo):
    """The same random program built in both packages."""
    return (random_program(random.Random(seed), n, ref_hlo),
            random_program(random.Random(seed), n, port_hlo))
