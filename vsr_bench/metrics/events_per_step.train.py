"""Device kernels and copies a train step in the trace."""


def read(t):
    if not t.on_card or not t.units:
        return None
    return len(t.events) / t.units
