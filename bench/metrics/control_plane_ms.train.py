"""Host milliseconds a step of the timeline window in the trainer's control
plane: the program's ``trainer.plan``, ``trainer.batch``, ``trainer.apply``,
``trainer.to_device`` and ``trainer.observe`` spans, averaged over the
window's steps."""
from bench.harness import spans


def read(ctx):
    win = spans.of(ctx)
    if win is None:
        return None
    return spans.per_step(win, spans.CONTROL_SPANS,
                          lambda sp: (sp.end_ns - sp.start_ns) / 1e6)
