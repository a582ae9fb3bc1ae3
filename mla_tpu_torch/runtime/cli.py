"""CLI entry point of the port (``mla_tpu/runtime/cli.py``):

    python -m mla_tpu_torch.runtime.cli [--device cuda|cpu] --train \\
        --dataset CREMAD --lorb base --gs_flag --data_root DIR ...

Every flag of the JAX package's CLI parses to the same ``MLAConfig``
(``core/config.py``, the port's copy), with the same --av_alpha default
(0.55 unless passed, main.py:968). ``--device`` is the port's own: the card
(the default) or the CPU; asking for the card on a machine without one
raises.
"""

from __future__ import annotations

import argparse
from typing import Tuple

from mla_tpu_torch.core.config import MLAConfig, config_from_args


def parse_args(argv=None) -> Tuple[MLAConfig, str]:
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ns, rest = p.parse_known_args(argv)
    return config_from_args(rest), ns.device


def main(argv=None):
    cfg, device = parse_args(argv)
    from mla_tpu_torch.runtime.driver import run
    run(cfg, device=device)


if __name__ == "__main__":
    main()
