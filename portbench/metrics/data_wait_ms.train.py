"""Host ms per step that the train loop waited for its next batch from
`prefetch` (the benchmark's wrapper on the iterator), over the window's steps."""


def read(ctx):
    return 1e3 * ctx["data_wait_s"] / ctx["steps"] if ctx["steps"] else None
