"""Image-quality evaluation over rendered sets — the port's counterpart of
the root ``metrics.py`` (reference: metrics.py:36-103), with the same
flags plus ``--device`` (default ``cuda``).

Walks ``<model>/test/<method>/{renders,gt}``, computes SSIM and PSNR,
and writes ``results.json`` and ``per_view.json`` with gsjax's keys.
LPIPS is not ported (ROADMAP Queue 1 item 4): no weights are needed or
fetched, and no LPIPS key is written.

Example:
    python -m gsjax_torch.metrics -m output/lego
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def read_images(renders_dir, gt_dir):
    """reference metrics.py:24-34."""
    from PIL import Image

    renders, gts, names = [], [], []
    for fname in sorted(os.listdir(renders_dir)):
        r = np.asarray(Image.open(os.path.join(renders_dir, fname)).convert("RGB"))
        g = np.asarray(Image.open(os.path.join(gt_dir, fname)).convert("RGB"))
        renders.append(r.astype(np.float32) / 255.0)
        gts.append(g.astype(np.float32) / 255.0)
        names.append(fname)
    return renders, gts, names


def evaluate(model_paths, device="cuda"):
    """reference metrics.py:36-93; SSIM and PSNR on ``device``."""
    import torch

    from gsjax_torch.eval.metrics import psnr
    from gsjax_torch.train.loss import ssim
    from gsjax_torch.utils.system import resolve_device

    dev = resolve_device(device)
    print("LPIPS is not ported (ROADMAP Queue 1 item 4); reporting SSIM/PSNR only.")

    full_results = {}
    for model_path in model_paths:
        print(f"Scene: {model_path}")
        try:
            full_dict, per_view = {}, {}
            test_dir = os.path.join(model_path, "test")
            for method in sorted(os.listdir(test_dir)):
                print(f"Method: {method}")
                mdir = os.path.join(test_dir, method)
                renders, gts, names = read_images(os.path.join(mdir, "renders"),
                                                  os.path.join(mdir, "gt"))
                if not names:
                    print("  (no rendered views — skipping)")
                    continue
                ssims, psnrs = [], []
                with torch.no_grad():
                    for r, g in zip(renders, gts):
                        rt, gt = torch.from_numpy(r).to(dev), torch.from_numpy(g).to(dev)
                        ssims.append(ssim(rt, gt))
                        psnrs.append(psnr(rt, gt))
                ssims = torch.stack(ssims).tolist()
                psnrs = torch.stack(psnrs).tolist()
                print(f"  SSIM : {np.mean(ssims):.7f}")
                print(f"  PSNR : {np.mean(psnrs):.7f}")
                full_dict[method] = {"SSIM": float(np.mean(ssims)),
                                     "PSNR": float(np.mean(psnrs))}
                per_view[method] = {"SSIM": dict(zip(names, map(float, ssims))),
                                    "PSNR": dict(zip(names, map(float, psnrs)))}
            with open(os.path.join(model_path, "results.json"), "w") as f:
                json.dump(full_dict, f, indent=2)
            with open(os.path.join(model_path, "per_view.json"), "w") as f:
                json.dump(per_view, f, indent=2)
            full_results[model_path] = full_dict
        except Exception as e:  # noqa: BLE001 — reference behavior: report, continue
            print(f"Unable to compute metrics for model {model_path}: {e}")
    return full_results


def main(argv=None):
    parser = argparse.ArgumentParser(description="gsjax_torch metrics")
    parser.add_argument("--model_paths", "-m", required=True, nargs="+", type=str)
    parser.add_argument("--device", default="cuda",
                        help="torch device to compute on (cuda or cpu)")
    args = parser.parse_args(argv)

    from gsjax_torch.utils.system import resolve_device

    resolve_device(args.device)  # fail before reading anything
    return evaluate(args.model_paths, device=args.device)


if __name__ == "__main__":
    main()
