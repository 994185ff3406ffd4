"""consensus_launches.sat (count): per sort job, the kernel launches that
ops/node_sum.GatherConsensus.sums issued in the SGD step (the counter
consensus.launches of the step's --trace-out line: per consensus the zero
fill, two cats and, per width class w, one gather and w - 1 adds),
averaged over the jobs.  None where no SGD line holds the counter."""

from statistics import fmean

KEY = "consensus.launches"


def read(run):
    vals = [sum(e["counts"][KEY] for e in j.steps
                if e["event"] == "SGD" and KEY in e.get("counts", {}))
            for j in run.jobs
            if any(e["event"] == "SGD" and KEY in e.get("counts", {})
                   for e in j.steps)]
    return fmean(vals) if vals else None
