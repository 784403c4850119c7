"""scene_load_s: seconds of the scene build, upload, LUTs and scene grid,
timed by the harness to the end of their device work (the slowest rank
on several cards). Moves setup_s."""


def read(ctx):
    return ctx.scene_load_s
