"""K2's share of its roofline (%): the summed bounds of the fused codebook
loop's launches in the traced steps (the family's ``k2_work`` at each launch's
batch) over their device time under the kernel's exact name."""


def read(run):
    t = run.trace
    if not t or "k2" not in t["groups"] or not t["bounds_s"].get("k2"):
        return None
    return 100.0 * t["bounds_s"]["k2"] / t["groups"]["k2"][1]
