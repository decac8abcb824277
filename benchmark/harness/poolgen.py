"""The pool process: makes a run's reads from its seed while the run warms
up (deploy.run_pool).

    python3 poolgen.py CONFIG CONFIG.json CACHE TRAFFIC.json SEED \
        SAMPLE.npy OUT_DIR

CONFIG names the deployment (built and cached already), SAMPLE.npy holds
the pool indices of the reads the check will compare. Imports nothing of
the program, and nothing that takes the measured process's interpreter
lock.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from harness import deploy  # noqa: E402


def main(argv):
    name, cfg_path, cache, tpath, seed, sample, out = argv
    dep = deploy.load(name, cfg_path, cache)
    deploy.run_pool(dep, json.load(open(tpath)), int(seed), np.load(sample),
                    out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
