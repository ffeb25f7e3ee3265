"""Smoke run of the engine on one GPU: the quickest proof that the main path
compiles and runs on the card and still computes the right thing.

    python chip_smoke.py            # one card: the phases below
    python chip_smoke.py --multi 4  # four cards: the spatial step only

Phases (one line each; any failure exits nonzero before the last line):

1. device — JAX's first device must be a GPU; the card's name and power
   limit as nvidia-smi reports them.
2. kernel — the fused solver-sweep kernel vs the jnp solve at the
   headline's widths.
3. oracle — the 217-body balls contact-stream parity vs the f64 oracle,
   with the step jitted on the card.
4. headline — stress_scene(100_000) stepped by the chunked host-adaptive
   driver from its initial block: 8 chunks of 64 steps.
5. mixed — stress_scene(100_000, mixed=True): 2 chunks of 16 steps.

The last line of stdout is one JSON object naming the device.
"""

import argparse
import json
import sys

import jax

from mgf_tpu.utils.runtime import (card_name_and_power, enable_compile_cache,
                                   require_gpu)


def result_line(devices) -> str:
    """The contract's last line."""
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}})


def _stress_line(name, r, card):
    peak = r["peak_bytes"]
    return (f"{name}: {r['bodies']} bodies, {r['chunks']} chunks x "
            f"{r['chunk']} steps, {r['steps_per_s']:.3f} steps/s median "
            f"(min {r['steps_per_s_min']:.3f}, max "
            f"{r['steps_per_s_max']:.3f}) on {card}; "
            f"compile+first chunks {r['compile_s']:.1f} s, "
            f"recompiles {r['recompiles']}, hot chunks {r['hot_chunks']}; "
            f"num_contacts {r['num_contacts']}, broadphase_overflow "
            f"{r['broadphase_overflow']}, max_penetration "
            f"{r['max_penetration']:.4f}, drift_excess "
            f"{r['drift_excess']}, escaped {r['escaped']}, nan {r['nan']}; "
            f"peak_bytes_in_use {peak}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--multi", type=int, default=0,
                    help="run only the spatial multi-device step on this "
                         "many cards")
    args = ap.parse_args()

    try:
        devs = require_gpu()
    except RuntimeError as e:
        sys.exit(f"chip_smoke: {e}")
    enable_compile_cache()
    from mgf_tpu import checks

    card = card_name_and_power()
    print(f"device: platform {devs[0].platform}, kind {devs[0].device_kind},"
          f" count {len(devs)}", flush=True)
    print(f"card: {card}", flush=True)

    if args.multi:
        r = checks.spatial_vs_single(n_devices=args.multi)
        print(f"spatial: {r}", flush=True)
        print(result_line(devs))
        return

    r = checks.solver_kernel_parity()
    print(f"kernel: R=12 N=100000 2x6 warm-started, worst |diff| "
          f"{r['worst_abs']:.3e}, worst |diff|/(atol+rtol|ref|) "
          f"{r['worst_ratio']:.3f} (limit 1; atol "
          f"{checks.KERNEL_TOL['atol']}, rtol "
          f"{checks.KERNEL_TOL['rtol']})", flush=True)

    worst, dvs, matmuls = checks.oracle_contact_parity()
    print(f"oracle: 217 bodies, 90 steps: miss {worst['miss']}/"
          f"{worst['total']}, dt {worst['dt']:.3e}, dn {worst['dn']:.3e}, "
          f"dp {worst['dp']:.3e} (bounds {checks.ORACLE_BOUNDS}); "
          f"median dv {float(jax.numpy.median(dvs)):.3e}; "
          f"matmuls in the step {matmuls[0]} "
          f"({matmuls[1]} below HIGHEST)", flush=True)
    checks.check_oracle_bounds(worst)
    if matmuls[1]:
        raise checks.CheckFailed("a matmul below HIGHEST precision in the "
                                 "oracle-parity step (TF32 on the GPU)")

    r = checks.stress_run(100_000, chunks=8, chunk=64)
    print(_stress_line("headline", r, card), flush=True)
    r = checks.stress_run(100_000, mixed=True, chunks=2, chunk=16)
    print(_stress_line("mixed", r, card), flush=True)

    print(result_line(devs))


if __name__ == "__main__":
    main()
