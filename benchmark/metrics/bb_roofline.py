"""The backbone step's share of its roofline (%): the summed bounds of its
launches in the traced steps (the family's ``bb_work`` at the configuration's
weight precision, each launch's batch and readable window slots) over their
device time under the kernels' exact names (K1 or K1q)."""


def read(run):
    t = run.trace
    if not t or "bb" not in t["groups"] or not t["bounds_s"].get("bb"):
        return None
    return 100.0 * t["bounds_s"]["bb"] / t["groups"]["bb"][1]
