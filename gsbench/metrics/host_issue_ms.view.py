"""Host milliseconds from a frame's call to its return, before the copy
to host memory (the frame graph's copy-in of the model, camera and
background, and its replay), averaged over the window's frames. Layer:
dispatch (make_render_fn)."""


def read(ctx):
    return ctx.get("host_issue_ms") if ctx["kind"] == "view" else None
