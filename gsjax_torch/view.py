"""Local interactive viewer for trained models — the port's counterpart of
the root ``view.py``, with the same flags plus ``--device`` (default
``cuda``).

The analogue of the reference's ``SIBR_gaussianViewer_app -m <model>``
(reference README.md:296-302), for headless hosts: a browser viewer served
over HTTP, rendering frames through the inference path
(``composite_infer`` on CUDA). Open the printed URL (tunnel the port if
remote).

    python -m gsjax_torch.view -m output/<run> [--iteration 30000] [--port 8080]
"""

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-m", "--model_path", required=True)
    ap.add_argument("--iteration", type=int, default=-1)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (cuda or cpu)")
    args = ap.parse_args(argv)

    from gsjax_torch.utils.system import resolve_device, safe_state

    device = resolve_device(args.device)  # fail before reading anything
    safe_state(args.quiet)

    from gsjax_torch.viewer.local_viewer import viewer_from_model

    viewer_from_model(
        args.model_path, iteration=args.iteration, device=device,
        host=args.host, port=args.port,
    ).serve_forever()


if __name__ == "__main__":
    main()
