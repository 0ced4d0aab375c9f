"""Per cent of its roofline the P-256 comb kernel reached in the window:
the least time the card needs for the window's signatures
(``portbench/roofline.py``) over the device time of ``comb_verify_kernel``
in the profiler's timeline."""

from portbench import roofline

KERNEL, VERIFY = "comb_verify_kernel", "p256_comb"


def read(run):
    tl = run.get("timeline")
    if tl is None or run["cfg"]["scheme"] != "p256":
        return None
    k = tl["kernels"].get(KERNEL)
    if not k or k["seconds"] <= 0 or not run.get("sigs_verified"):
        return None
    bound = roofline.bound_s(VERIFY, run["sigs_verified"], k["launches"],
                             run["keys"])
    return 100.0 * bound / k["seconds"]
