"""Command line of the port.

    python -m localai_tpu_torch.cli.main run --models-path models \\
        --port 8080 [--address 127.0.0.1] [--device cuda|cpu]

``run`` registers every model YAML in ``--models-path`` and serves the
OpenAI-compatible API; each model loads on its first request. The card is
the default device; ``--device cpu`` runs on the CPU (slow — tests and
small debug models only).
"""

from __future__ import annotations

import argparse
import logging
import sys

from localai_tpu_torch.api.server import APIServer
from localai_tpu_torch.config.app_config import AppConfig
from localai_tpu_torch.config.loader import ConfigLoader
from localai_tpu_torch.models.manager import ModelManager
from localai_tpu_torch.utils.device import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="localai_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    run = sub.add_parser("run", help="serve the OpenAI-compatible API")
    run.add_argument("--models-path", default="models")
    run.add_argument("--address", default="127.0.0.1")
    run.add_argument("--port", type=int, default=8080)
    run.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    run.add_argument("--context-size", type=int, default=4096)
    run.add_argument("--log-level", default="INFO")
    args = ap.parse_args(argv)
    logging.basicConfig(level=args.log_level.upper(),
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    resolve_device(args.device)  # no card and no --device cpu: fail now
    app = AppConfig(model_path=args.models_path,
                    context_size=args.context_size, device=args.device,
                    address=args.address, port=args.port)
    loader = ConfigLoader(app.model_path)
    loader.load_from_path(context_size=app.context_size)
    server = APIServer(ModelManager(app, loader), app.address, app.port)
    logging.getLogger(__name__).info(
        "serving %s on %s (device %s)", loader.names(), server.url,
        app.device)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
