"""Print the resolved config (reference tools/misc/print_config.py).

Port of tools/analysis/print_config.py of the JAX package: --config
prints the model, train and AL dataclasses a reference-style config file
maps to (utils/config.py load_reference_config); without it, the
default config of --family (retinanet or ssd).

    python -m aod_meh_hua_torch.tools.print_config [--family retinanet|ssd] [--config c.py]
"""

from __future__ import annotations

import argparse
import dataclasses
import pprint
from typing import Optional, Sequence

from aod_meh_hua_torch.utils.config import RetinaNetConfig, SSDConfig, load_reference_config


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="Print the resolved config")
    ap.add_argument("--family", default="retinanet", choices=["retinanet", "ssd"])
    ap.add_argument("--config", default=None, help="reference-style config file")
    args = ap.parse_args(argv)
    if args.config:
        model_cfg, train_cfg, al_cfg, _ = load_reference_config(args.config)
        for name, cfg in (("model", model_cfg), ("train", train_cfg), ("al", al_cfg)):
            print(f"== {name} ==")
            pprint.pprint(dataclasses.asdict(cfg))
    else:
        pprint.pprint(dataclasses.asdict(SSDConfig() if args.family == "ssd"
                                         else RetinaNetConfig()))


if __name__ == "__main__":
    main()
