"""The KV-batch VLM's build in set-up, in s: ``stack.build_vlm_store``'s
host clock from drawing the VLM's weights to the store's compressed
caches (the prefill, the calibration's query statistics and the
Expected-Attention press), ended by a device sync."""


def read(ctx):
    return ctx.setup.get("vlm_build")
