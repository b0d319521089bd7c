"""A report's catalog against the preset's truth stars: the sources at
prevalence >= 0.5 matched one to one to the truth within 1 px, the truth
stars left unmatched (by index into the truth catalog, with their x, y and
flux) and the sources that match no truth star.

It reads the ``P_catalog.json`` that ``python -m starcat_torch report``
writes, or the one of the JAX package's ``python -m starcat report`` (the
same format), and takes the truth from the port's stored scene
(starcat_torch/data/scenes.npz, the scene ``make_data()`` draws), so it
imports no JAX:

    python scripts/report_truth_match_torch.py --config cfg6_chees \\
        build/report/cfg6_chees_catalog.json

It prints one JSON line.  chip_smoke.py's phase 14 gate
(``REPORT_REFERENCE``) comes from this script's reading of the JAX
package's reports.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--radius", type=float, default=1.0)
    ap.add_argument("--min-prevalence", type=float, default=0.5)
    ap.add_argument("catalog")
    args = ap.parse_args(argv)

    from starcat_torch.catalogs import match_catalogs
    from starcat_torch.configs import CONFIGS
    from starcat_torch.potential import constrain

    cfg = CONFIGS[args.config]
    truth_theta, _ = cfg.make_data()
    truth = np.stack([t.numpy() for t in constrain(truth_theta, cfg.scene)], axis=1)
    with open(args.catalog) as fh:
        cat = json.load(fh)
    solid = np.array([[c["x"], c["y"], c["flux"]] for c in cat["condensed"]
                      if c["prevalence"] >= args.min_prevalence]).reshape(-1, 3)
    pairs, un_truth, un_solid = match_catalogs(truth, solid, args.radius)
    print(json.dumps({
        "config": args.config, "catalog": args.catalog,
        "n_draws_used": cat["n_draws_used"], "n_sources": len(solid),
        "n_truth": len(truth), "n_matched": len(pairs),
        "truth_unmatched": un_truth.tolist(),
        "truth_unmatched_xyf": truth[un_truth].round(3).tolist(),
        "sources_unmatched_xyf": solid[un_solid].round(3).tolist()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
