"""End-to-end metric `setup_s`, host clock: seconds from the start of the
run to the first timed unit (keys, the hand-over to the program, its build
on a checkout's first run, the warm-up)."""


def read(ctx):
    return ctx.setup_s
