"""Tokens the window's steps trained, after the curriculum's cut, over the
window's host-clock seconds (its last step ends in a synchronise)."""


def read(ctx):
    w = ctx.window
    return w["tokens"] / w["seconds"] if w["seconds"] > 0 else None
