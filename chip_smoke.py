"""Smoke test of the multigrid Poisson solver on NVIDIA GPUs.

    python chip_smoke.py                # one card
    python chip_smoke.py --four-cards   # the flagship sharded over four cards

One process drives the card(s).  Every phase must pass; nothing is caught.

Without options:

1. device check: the first JAX device is a GPU, else exit nonzero; prints
   the card's name and power limit as nvidia-smi reports them;
2. three solves through the user entry point ``models.poisson.run_config``,
   at the reference study's sizes (data.pdf), each with its own line: the
   flagship anisotropy Q4 17M DoF (5 its), Kershaw Q4 7.2M DoF (<= 55 its)
   and ball Q4 8.4M DoF (<= 7 its);
3. accuracy at full width on the flagship grid: the f32 level operator, the
   FDM apply and the plain smoother step, at the matmul precisions the
   flagship solve uses, against f64 evaluations of the same operators,
   rel-L2 within stated tolerances.

``peak_bytes_in_use`` is the process's high-water mark (JAX cannot reset
it); ``peak_is_own`` says whether the solve raised it, and
``bytes_in_use_before`` what earlier phases still held when it started, so
a solve that raised the mark peaked at the difference of the two.  The
flagship goes first, so its peak is always its own.

With ``--four-cards``: only the flagship with ``"n devices": 4``
(explicit-halo sharding over a 1-D mesh of the four cards, halos by
``ppermute``), which must take the one-card run's 5 iterations, and the
one-card flagship it is compared with, in the same process.  Every card
must hold at least its share of the outer CG's vectors; the per-card peaks
are printed by set-up stage.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import jax

HERE = os.path.dirname(os.path.abspath(__file__))

# iteration contracts (reference: data.pdf Tables 1, 13 and 15)
FLAGSHIP_ITS = 5
KERSHAW_MAX_ITS = 55  # the reference takes 51; this solver recorded 55
BALL_MAX_ITS = 7      # the reference takes 6

# rel-L2 tolerances of the f32 level arithmetic against f64 at full width.
# Level operator, true-f32 ("highest") matmuls: 1.9e-8 measured on the H100
# at 17M DoF; 1e-5 keeps a wide margin and fails TF32 operands (1.1e-4).
OPERATOR_TOL = 1e-5
# FDM apply and smoother step at the flagship config's FDM precision, TF32
# (chosen for speed; the FDM only preconditions): 1.0e-3 measured at 17M
# DoF.  TF32 keeps 10 mantissa bits (unit roundoff 4.9e-4); 5e-3 bounds it
# with margin and still fails bf16 operands (unit roundoff 3.9e-3 and more).
FDM_TOL = 5e-3


def log(msg):
    print(msg, flush=True)


def check_device():
    """The platform must be a GPU: no phase of this script runs elsewhere."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU found (JAX platform "
                         f"{dev.platform!r}); this script runs only on GPUs")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    for line in smi.stdout.strip().splitlines():
        log(f"card: {line}")
    return dev


def load_config(name):
    with open(os.path.join(HERE, "experiments", name)) as f:
        return json.load(f)


def peak_bytes(dev):
    return dev.memory_stats()["peak_bytes_in_use"]


def live_bytes(dev):
    return dev.memory_stats()["bytes_in_use"]


def fdm_precision(params):
    """The FDM smoother's matmul precision named by a solve config."""
    smoother = params["preconditioner"]["mg smoother"]
    return smoother["preconditioner"].get("matmul precision")


def solve(name, params, check, setup_log=None):
    """One solve through run_config; ``check(its)`` states the contract.
    ``setup_log`` receives run_config's set-up log."""
    from dealii_asm.models.poisson import run_config

    live_before = live_bytes(jax.devices()[0])
    peak_before = peak_bytes(jax.devices()[0])
    r = run_config(params, log=setup_log or (lambda *_: None))
    peak = peak_bytes(jax.devices()[0])
    if not r["converged"] or not check(r["it"]):
        raise SystemExit(f"chip_smoke: {name} failed its iteration contract "
                         f"(converged={r['converged']}, its={r['it']})")
    log(json.dumps({
        "solve": name, "n_dofs": r["n_dofs"], "its": r["it"],
        "solve_s": r["time"], "setup_s": r["setup_time"],
        "first_solve_s": r["first_solve_time"],
        "peak_bytes_in_use": peak, "peak_is_own": peak > peak_before,
        "bytes_in_use_before": live_before}))
    return r


def rel_l2(a, ref):
    import numpy as np

    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(a - ref) / np.linalg.norm(ref))


def accuracy(cells=64, degree=4):
    """f32 level arithmetic against f64 on the flagship grid, at the
    precisions the flagship solve uses."""
    import jax.numpy as jnp
    import numpy as np

    from dealii_asm.fem.dofs import DofHandler
    from dealii_asm.mesh.grid import StructuredMesh
    from dealii_asm.models.poisson import LEVEL_MATMUL_PRECISION
    from dealii_asm.ops.laplace import LaplaceOperator
    from dealii_asm.precond.asm import ASMPreconditioner

    dofs = DofHandler(StructuredMesh(3, (cells,) * 3), degree)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(dofs.n_dofs), jnp.float32)
    b = jnp.asarray(rng.standard_normal(dofs.n_dofs), jnp.float32)
    x64, b64 = x.astype(jnp.float64), b.astype(jnp.float64)
    omega = 0.3

    precision = fdm_precision(load_config("e2e_aniso_q4.json"))

    def fdm(dtype):
        return ASMPreconditioner(dofs, n_overlap=1, weighting_type="symm",
                                 dtype=dtype, matmul_precision=precision)

    # the MG level operator as the solver builds it, and its f64 twin
    op = LaplaceOperator(dofs, dtype=jnp.float32,
                         matmul_precision=LEVEL_MATMUL_PRECISION)
    op64 = LaplaceOperator(dofs, dtype=jnp.float64)
    asm, asm64 = fdm(jnp.float32), fdm(jnp.float64)
    step = jax.jit(lambda y, c: y + omega * asm.vmult_traceable(
        c - op.vmult_traceable(y)))
    results = [
        ("f32 level operator", OPERATOR_TOL,
         rel_l2(op.vmult(x), op64.vmult(x64))),
        (f"f32 FDM apply ({asm.matmul_precision})", FDM_TOL,
         rel_l2(asm.vmult(x), asm64.vmult(x64))),
        ("f32 smoother step", FDM_TOL,
         rel_l2(step(x, b),
                x64 + omega * asm64.vmult(b64 - op64.vmult(x64)))),
    ]
    for name, tol, err in results:
        log(json.dumps({"accuracy": name, "n_dofs": dofs.n_dofs,
                        "rel_l2_vs_f64": err, "tolerance": tol}))
    bad = [name for name, tol, err in results if not err <= tol]
    if bad:
        raise SystemExit(f"chip_smoke: accuracy out of tolerance: {bad}")


def one_card():
    solve("aniso q4 (flagship)", load_config("e2e_aniso_q4.json"),
          lambda its: its == FLAGSHIP_ITS)
    solve("kershaw q4", load_config("e2e_kershaw_q4.json"),
          lambda its: its <= KERSHAW_MAX_ITS)
    solve("ball q4", load_config("e2e_ball_q4.json"),
          lambda its: its <= BALL_MAX_ITS)
    accuracy()


def four_cards():
    devices = jax.devices()
    if len(devices) < 4:
        raise SystemExit(f"chip_smoke: --four-cards needs 4 GPUs, found "
                         f"{len(devices)}")
    cards = devices[:4]
    params = load_config("e2e_aniso_q4.json")
    params["n devices"] = 4
    # per-card peaks at each set-up stage run_config logs: growth listed
    # under a stage happened while that stage ran
    stages, stage = [], ["start"]

    def setup_log(msg=""):
        peaks = [peak_bytes(d) for d in cards]
        if not stages or peaks != stages[-1][1]:
            stages.append([stage[0], peaks])
        text = str(msg).strip()
        stage[0] = text.splitlines()[0] if text else stage[0]

    r4 = solve("aniso q4 (flagship), 4 cards", params,
               lambda its: its == FLAGSHIP_ITS, setup_log)
    peaks = [peak_bytes(d) for d in cards]
    stages.append([f"{stage[0]} (to the end of the solves)", peaks])
    log(json.dumps({"peak_bytes_in_use_per_card": peaks,
                    "peaks_by_setup_stage": stages}))
    # every card's share of the outer CG's four f64 vectors (x, r, p, Ap):
    # a card holding less does not hold its part of the solve
    share = 4 * 8 * r4["n_dofs"] // len(cards)
    if min(peaks) < share:
        raise SystemExit("chip_smoke: the sharded solve left a card "
                         f"(nearly) idle: peaks {peaks}, share {share}")
    r1 = solve("aniso q4 (flagship), 1 card", load_config(
        "e2e_aniso_q4.json"), lambda its: its == FLAGSHIP_ITS)
    if r1["it"] != r4["it"]:
        raise SystemExit(f"chip_smoke: 4 cards took {r4['it']} its, "
                         f"1 card {r1['it']}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the flagship over four cards, with its "
                         "one-card comparison")
    args = ap.parse_args(argv)
    dev = check_device()
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, HERE)
    from dealii_asm.utils.jitutils import enable_compilation_cache

    enable_compilation_cache()
    t0 = time.perf_counter()
    if args.four_cards:
        four_cards()
    else:
        one_card()
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
