"""Device operations a decode step, over the profiled steps."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not tr.ops or not ctx.get("traced_steps"):
        return None
    return len(tr.ops) / ctx["traced_steps"]
