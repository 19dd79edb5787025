"""Share of its roofline that the edge-system kernel (K1,
csrc/edge_system.cu) reaches over the window: the least time of every
launch's work (formulas.edge_system_work at the launch's shapes) over the
kernel's device time in the profile."""


def install(rec):
    rec.kernel_work()


def read(rec):
    bound = rec.total("edge_system.bound_s")
    if not bound or rec.profile is None:
        return None
    t = sum(s for n, s in rec.profile["kernel_s"].items()
            if "edge_system_kernel" in n)
    return 100.0 * bound / t if t > 0 else None
