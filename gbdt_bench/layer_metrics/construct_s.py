"""Seconds of the train Dataset's construct() (host clock, ending in a
synchronise)."""


def read(ctx):
    return ctx.construct_s
