"""Share of its roofline that the alt-corr kernel (K2, csrc/alt_corr.cu,
global BA's correlation) reaches over the window: the least time of every
launch's work (formulas.alt_corr_work at the launch's shapes and
in-bounds taps) over the kernel's device time in the profile."""


def install(rec):
    rec.kernel_work()


def read(rec):
    bound = rec.total("alt_corr.bound_s")
    if not bound or rec.profile is None:
        return None
    t = sum(s for n, s in rec.profile["kernel_s"].items()
            if "alt_corr_kernel" in n)
    return 100.0 * bound / t if t > 0 else None
