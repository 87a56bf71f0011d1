"""K3 (``qmm_`` kernels): the least time of every int8 product of a
forward (2·M·K·N at the int8 peak, or its bytes: fp32 activations in,
int8 weights, fp32 out), over K3's device time per forward in the
trace, in percent."""


def read(r):
    tr = r.get("trace")
    if tr is None or "k3.least_s" not in r:
        return None
    events, seconds = tr.kernels.get("k3", (0, 0.0))
    if r.get("k3.launches") != events:
        raise RuntimeError(f"k3: {r.get('k3.launches')} launches counted, "
                           f"{events} kernel events traced")
    if events == 0:
        return None
    return 100.0 * r["k3.least_s"] * r["forwards"] / seconds
