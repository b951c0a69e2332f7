"""Isolated per-config measurement worker — the port of
``drstencil_tpu/tune/worker.py``.

Reads one JSON job from stdin (``{stc, name, config, pairs, check,
device}``), runs the in-process tuner's measurement
(``tune.tuner.measure_config``), and prints the ledger entry as one
marker-prefixed JSON line on stdout.  A hung build or kernel dies with
this process; the parent kills it at its per-config timeout.

Run as ``python -m drstencil_tpu_torch.tune.worker``.  Test hook:
``DRSTENCIL_TEST_HANG=<seconds>`` sleeps before anything else, standing
in for a hang.
"""

import json
import os
import sys
import time


def main():
    hang = os.environ.get("DRSTENCIL_TEST_HANG")
    if hang:
        time.sleep(float(hang))

    job = json.load(sys.stdin)

    from drstencil_tpu_torch.ir.spec import parse_stc
    from drstencil_tpu_torch.ops.config import KernelConfig
    from drstencil_tpu_torch.tune.tuner import RESULT_MARKER, measure_config

    spec = parse_stc(job["stc"], name=job["name"])
    cfg = KernelConfig.from_dict(job["config"])
    entry = measure_config(spec, cfg, pairs=job.get("pairs", 10),
                           check=job.get("check", True),
                           device=job.get("device"))
    sys.stdout.write(RESULT_MARKER + json.dumps(entry) + "\n")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
