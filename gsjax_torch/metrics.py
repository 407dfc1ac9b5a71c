"""Image-quality evaluation over rendered sets — the port's counterpart of
the root ``metrics.py`` (reference: metrics.py:36-103), with the same
flags plus ``--device`` (default ``cuda``).

Walks ``<model>/test/<method>/{renders,gt}``, computes SSIM / PSNR (and
LPIPS-vgg when its gated weights are present — see
gsjax_torch/eval/lpips.py), and writes ``results.json`` and
``per_view.json`` with gsjax's keys.

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
    """reference metrics.py:36-93; every metric on ``device``."""
    import torch

    from gsjax_torch.eval import lpips as lpips_mod
    from gsjax_torch.eval.metrics import psnr
    from gsjax_torch.train.loss import ssim
    from gsjax_torch.utils.system import resolve_device

    dev = resolve_device(device)
    lpips_params = None
    if lpips_mod.available():
        lpips_params = lpips_mod.load_weights(device=dev)
    else:
        print(
            "LPIPS weights unavailable (no egress in this environment); "
            "reporting SSIM/PSNR only. See gsjax_torch/eval/lpips.py."
        )

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
                ssims, psnrs, lpipss = [], [], []
                with torch.no_grad():
                    for r, g in zip(renders, gts):
                        rt, gt = torch.from_numpy(r).to(dev), torch.from_numpy(g).to(dev)
                        ssims.append(ssim(rt, gt))
                        psnrs.append(psnr(rt, gt))
                        if lpips_params is not None:
                            lpipss.append(lpips_mod.lpips(rt, gt, lpips_params))
                ssims = torch.stack(ssims).tolist()
                psnrs = torch.stack(psnrs).tolist()
                lpipss = torch.stack(lpipss).tolist() if lpipss else []
                print(f"  SSIM : {np.mean(ssims):.7f}")
                print(f"  PSNR : {np.mean(psnrs):.7f}")
                if lpipss:
                    print(f"  LPIPS: {np.mean(lpipss):.7f}")
                full_dict[method] = {"SSIM": float(np.mean(ssims)),
                                     "PSNR": float(np.mean(psnrs))}
                per_view[method] = {"SSIM": dict(zip(names, map(float, ssims))),
                                    "PSNR": dict(zip(names, map(float, psnrs)))}
                if lpipss:
                    full_dict[method]["LPIPS"] = float(np.mean(lpipss))
                    per_view[method]["LPIPS"] = dict(zip(names, map(float, lpipss)))
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
