"""The program's own record of the traced sweep, for the per-layer
readers: ``repro_torch.core.obs`` keeps one record a ``Sweep.run`` that
runs under the profiler, so after ``harness.trace`` the newest is the
traced sweep's.  A program without that module keeps none, and every
reader of it then returns None."""


def last():
    """The newest record of the program (None: it keeps none)."""
    try:
        from repro_torch.core import obs
    except ImportError:
        return None
    return obs.last()


def span_ms(name: str):
    """Milliseconds of the traced sweep's spans ``name`` together."""
    rec = last()
    return None if rec is None else rec.ms(name)


def mb(counter: str):
    """A byte counter of the traced sweep in MB."""
    rec = last()
    return None if rec is None else rec.counters[counter] / 1e6


def card_mb(counter: str):
    """A byte counter of the traced sweep in MB, where it ran on a card
    (on the CPU nothing crosses to a card)."""
    rec = last()
    if rec is None or not rec.on_card:
        return None
    return rec.counters[counter] / 1e6


def mega(rec):
    """``rec`` where it ran the megakernel with its timers on (on a card,
    mega tier), else None."""
    if rec is None or rec.tier != "mega" or not rec.window_ms or \
            rec.mega_loop_ns is None:
        return None
    return rec
