"""Materialize the default FullOVSLAMConfig to JSON —
``write_configuration`` equivalent (src/refactoring/configuration/write_configuration.cpp).

The port's counterpart of ``cli/write_configuration.py``:

    python -m obvi_slam_tpu_torch.cli.write_configuration \\
        --config_output_file config.json
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config_output_file", required=True)
    parser.add_argument("--config_version_id", default="default")
    args = parser.parse_args(argv)

    import numpy as np

    from obvi_slam_tpu_torch.config import (
        FullOVSLAMConfig,
        ShapeDimensionPrior,
        write_config,
    )

    config = FullOVSLAMConfig(config_version_id=args.config_version_id)
    # Default shape priors matching write_configuration.cpp's classes.
    defaults = [
        ("chair", [0.62, 0.62, 0.975], [0.05, 0.05, 0.05]),
        ("bench", [1.0, 2.5, 1.5], [1.5, 2.0, 1.5]),
        ("roadblock", [0.29, 0.29, 0.48], [0.001, 0.001, 0.01]),
        ("treetrunk", [0.4, 0.4, 2.0], [0.2, 0.2, 3.0]),
        ("lamppost", [0.3, 0.3, 4.0], [0.15, 0.15, 3.0]),
        ("trashcan", [0.73, 0.73, 1.2], [0.15, 0.15, 0.2]),
    ]
    config.shape_dimension_priors = [
        ShapeDimensionPrior(cls, np.array(mean), np.diag(np.array(std) ** 2))
        for cls, mean, std in defaults
    ]
    write_config(config, args.config_output_file)
    print(f"wrote default config to {args.config_output_file}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
