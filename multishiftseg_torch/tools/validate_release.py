"""Released-checkpoint accuracy validation, and the per-checkpoint qualification
of the approximate eval modes.

Counterpart of ``tools/validate_release.py``: evaluate RoadAnomaly with a
released checkpoint, hold AUROC / AUPRC / FPR@95 within ``--tolerance``
percentage points of the published numbers (``README.md:140-146``), and for
``--model m2f`` re-measure every approximate mode of ``QUAL_MODES`` on the
same weights and dataset against the measured exact ``bilinear`` result, each
gated at the same tolerance. The verdicts go next to the checkpoint
(``<stem>.sampling_qualification.json``), where
``train.test_runner.check_sampling_qualification`` reads them: a mode recorded
``qualified: false`` is refused for these weights until re-qualified.

    python -m multishiftseg_torch.tools.validate_release --model m2f \\
        --weight_path m2f_best.pth [--road_anomaly_root datasets/road_anomaly]

The port fetches nothing: ``--weight_path`` is required. Exit codes: 0 all
within tolerance; 1 a metric outside it; 2 no result (dataset missing); 3 the
exact path passed but an approximate mode was refused.
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path
from typing import Dict, Optional, Sequence

# README.md:143-144, RoadAnomaly rows (AUROC / AUPRC / FPR@95, percent)
PUBLISHED = {
    "deeplab": {"AUROC": 96.40, "AUPRC": 74.60, "FPR_TPR95": 16.08},
    "m2f": {"AUROC": 97.94, "AUPRC": 90.17, "FPR_TPR95": 7.54},
}

# the approximate eval modes to (re-)measure per checkpoint: a sample mode of
# test_runner --sample_mode, '+lowres' for --score_lowres, '+topq{Q}' for
# --score_topq Q
QUAL_MODES = ("nearest", "shared", "int8", "nearest_top6c",
              "nearest+lowres", "nearest+topq32")

REPO = Path(__file__).resolve().parents[2]


def qualify_sampling_modes(cfg, weight_path: str, dataset_name: str, dataset_root: str,
                           bilinear_pts: Dict[str, float], tolerance: float,
                           tta: bool = False, modes: Sequence[str] = QUAL_MODES,
                           device="cuda") -> dict:
    """Measure every mode of ``modes`` on the same weights and dataset and gate
    each at +-``tolerance`` percentage points of the exact result
    (``bilinear_pts``: {"AUROC": pts, ...}). Returns the qualification record
    that ``check_sampling_qualification`` reads. The forwards are built with
    ``enforce_qualification=False``, so a refused mode can be re-measured."""
    from ..train import test_runner

    out = {"dataset": dataset_name, "tolerance_pts": tolerance,
           "bilinear_pts": {k: round(v, 4) for k, v in bilinear_pts.items()},
           "modes": {}}
    for mode in modes:
        base, _, suffix = mode.partition("+")
        fwd = test_runner.build_m2f_forward(
            cfg, weight_path, device=device, sample_mode=base, enforce_qualification=False,
            score_lowres=suffix == "lowres",
            score_topq=int(suffix[4:]) if suffix.startswith("topq") else 0)
        ev = test_runner.OODEvaluator(cfg, fwd, {dataset_name: dataset_root}, tta=tta)
        got = ev.test_all((dataset_name,)).get(dataset_name)
        rec = {"qualified": False, "error": "evaluation produced no result"}
        if got:
            vals = {k: 100.0 * float(got[k]) for k in bilinear_pts}
            deltas = {k: round(vals[k] - bilinear_pts[k], 4) for k in vals}
            rec = {"metrics_pts": {k: round(v, 4) for k, v in vals.items()},
                   "delta_pts": deltas,
                   "qualified": all(abs(d) <= tolerance for d in deltas.values())}
        out["modes"][mode] = rec
    return out


def write_qualification(weight_path: str, record: dict) -> Path:
    """Write ``record`` where the gate reads it, next to the checkpoint."""
    from ..train.test_runner import sampling_qualification_path

    path = sampling_qualification_path(weight_path)
    path.write_text(json.dumps(record, indent=1))
    return path


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=["deeplab", "m2f"], required=True)
    ap.add_argument("--cfg", default=None,
                    help="experiment yaml (defaults to exps/<model>.yaml)")
    ap.add_argument("--weight_path", required=True, help="the released checkpoint")
    ap.add_argument("--road_anomaly_root", default=None)
    ap.add_argument("--tolerance", type=float, default=0.5,
                    help="max |delta| in percentage points (BASELINE.md budget)")
    ap.add_argument("--tta", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--skip_sampling_qualification", action="store_true",
                    help="m2f: do not re-qualify the approximate modes on these weights")
    args = ap.parse_args(argv)

    from ..core.config import load_config
    from ..train.test_runner import OODEvaluator, build_deeplab_forward, build_m2f_forward

    logging.basicConfig(level=logging.INFO)
    cfg = load_config(args.cfg or str(REPO / "exps" / f"{args.model}.yaml"),
                      f"validate_{args.model}")
    if args.road_anomaly_root:
        cfg.data.road_anomaly_root = args.road_anomaly_root
    build = build_deeplab_forward if args.model == "deeplab" else build_m2f_forward
    fwd = build(cfg, args.weight_path, device=args.device)
    ev = OODEvaluator(cfg, fwd, {"RoadAnomaly": cfg.data.road_anomaly_root}, tta=args.tta)
    got = ev.test_all(("RoadAnomaly",)).get("RoadAnomaly")
    if not got:
        print("FAIL: RoadAnomaly evaluation produced no result "
              "(dataset missing at --road_anomaly_root?)")
        return 2

    want = PUBLISHED[args.model]
    ok = True
    print(f"\n{args.model} RoadAnomaly vs README.md:143-144 "
          f"(tolerance +-{args.tolerance} pts):")
    for k, ref in want.items():
        val = 100.0 * float(got[k])
        line_ok = abs(val - ref) <= args.tolerance
        ok &= line_ok
        print(f"  {k:10s} {val:7.2f}  published {ref:7.2f}  delta {val - ref:+.2f}  "
              f"{'OK' if line_ok else 'OUT OF BUDGET'}")
    print("PASS" if ok else "FAIL")
    if not ok:
        return 1

    if args.model == "m2f" and not args.skip_sampling_qualification:
        bilinear_pts = {k: 100.0 * float(got[k]) for k in want}
        qual = qualify_sampling_modes(cfg, args.weight_path, "RoadAnomaly",
                                      cfg.data.road_anomaly_root, bilinear_pts,
                                      args.tolerance, tta=args.tta, modes=QUAL_MODES,
                                      device=args.device)
        path = write_qualification(args.weight_path, qual)
        refused = [m for m, r in qual["modes"].items() if not r["qualified"]]
        print(f"\napproximate-mode qualification (+-{args.tolerance} pts vs measured "
              f"bilinear; recorded at {path}):")
        for m, r in qual["modes"].items():
            print(f"  {m:16s} {'QUALIFIED' if r['qualified'] else 'REFUSED'}  "
                  f"{r.get('delta_pts', r.get('error'))}")
        if refused:
            print(f"MODES REFUSED: {refused}; test_runner rejects them for these "
                  "weights until re-qualified")
            return 3
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
