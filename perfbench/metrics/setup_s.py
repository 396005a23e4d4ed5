"""Set-up: process start to the window's start (imports, the CUDA
context, weights drawn on the card, warm-up and graph captures; in a
fresh checkout also the kernel library's build)."""


def read(ctx):
    return ctx.setup_s
