"""Sweep the OCS protocol across wireless scenarios in one engine call per
depth.

Evaluates every registered named scenario plus a workers x
miss-probability grid with the batched engine (``repro_torch.sim``), then
prints the merged measured/analytic table and writes it as JSON.  The
whole grid costs one core call per backoff depth (``bits``) and one noisy
core call per ``(bits, id_bits)`` group.

  python -m repro_torch.examples.scenario_sweep [out.json] [--rounds 4]
"""

import argparse

from repro_torch.sim import results, scenarios, sweep


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default=None)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cells = [scenarios.get(n) for n in scenarios.names()]
    cells += scenarios.scenario_grid(
        n_workers=(4, 16, 64), bits=(8, 16), p_miss=(0.0, 0.02, 0.1))

    sweep.reset_dispatch_counts()
    sw = sweep.run_sweep(cells, k_elems=64, rounds=args.rounds,
                         device=args.device)
    records = results.summarize(sw)

    for row in results.to_rows(records):
        print(row)
    calls = sweep.dispatch_counts()
    print(f"# {len(cells)} cells, core calls: clean={calls['clean']} "
          f"noisy={calls['noisy']}")

    if args.out:
        results.write_json(records, args.out)
        print(f"# wrote {args.out}")
    return records


if __name__ == "__main__":
    main()
