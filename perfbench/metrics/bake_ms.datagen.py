"""bake_ms.datagen: the datagen pipeline's own host seconds of baking a
wave's scenes (``pipeline_3d``'s ``bake_s``: ``datagen3d.bake_3d``, the
object's properties and the block's scenes), over its waves."""


def read(window):
    s = window.records.get("summary")
    if not s or not s.get("waves"):
        return None
    return 1e3 * s["bake_s"] / s["waves"]
