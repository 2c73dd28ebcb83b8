"""pack_builds_per_call: the program's ``pack_builds`` counter per call:
the builds of its shading packs (the tri pack, the light pack, and the
uv-opacity pack where the scene has an opacity texture), a replayed graph
counting the builds captured into it. Read from the program's own record
of the traced calls; a program without the counter gives nothing."""

from perfbench.harness import record


def read(ctx):
    return record.per_call("counts", "pack_builds")
