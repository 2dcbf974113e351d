"""Device layer: the share of the profiled serving stretch in which no
operation ran on the card (one minus the union of the device operations'
intervals over the stretch)."""


def read(r, trace):
    if trace is None or r["kind"] != "infer":
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
