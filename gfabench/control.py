"""The control of the comparison that decides ``correct``, at a cell's own
size, on the card:

    python -m gfabench.control --workload <cell> --seeds 11,12,13

For each seed it makes the input of the run's first window job, runs that
job through the program (as a run does) and reads the program's numbers
(:func:`gfabench.run.compare`); then it puts the control in the
program's place, the plain reference with its state rounded to bfloat16
after every sweep and consensus (the precision below the configuration's
float32), and reads the same numbers for it.  Both are judged by the
limits of a run (:func:`gfabench.run.judge`): the control's ``correct``
has to come out false.  One JSON line per seed.
The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

__all__ = ["bf16_state", "main"]


def bf16_state(t):
    """The state as bfloat16 holds it, back in the state's dtype."""
    import torch

    return t.to(torch.bfloat16).to(t.dtype)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, one job each")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from .jobs import check_job, make_job, run_job
    from .reference.pipeline import run_job as reference_job
    from .run import compare, judge
    from .spec import load_cell

    cell = load_cell(args.workload)
    work = Path(tempfile.gettempdir()) / "gfabench-control" / args.workload
    for seed in (int(s) for s in args.seeds.split(",")):
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir(parents=True)
        try:
            job = make_job(cell.config, cell.traffic, work, seed, 1)
            run_job(job)
            check_job(job)
            t0 = time.perf_counter()
            ref = reference_job(job.argv, args.device)
            numbers = {"failed_jobs": int(job.failed)}
            if job.rc == 0:
                numbers.update(compare(job, args.device, ref=ref))
            program, program_ok = judge(numbers)
            t1 = time.perf_counter()
            control, control_ok = judge(compare(job, args.device,
                                                bf16_state, ref))
            rec = {"workload": args.workload, "seed": seed, "rc": job.rc,
                   "job_s": job.wall_s, "breaks": job.breaks,
                   "program": {"correct": program_ok, "checks": program},
                   "control": {"correct": control_ok, "checks": control},
                   "reference_s": t1 - t0,
                   "control_s": time.perf_counter() - t1}
        finally:
            shutil.rmtree(work, ignore_errors=True)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
