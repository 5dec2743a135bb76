"""subtile_share.render: the share of the (ray, sub-tile) entries offered to
2b's test phase (``csrc/fused_queue.cu`` over ``csrc/pairs.cuh``) that its
cull kept over the traced renders, in percent: 100 x the sum of
``subtiles_tested`` over the sum of ``subtiles_offered`` in the program's
counter record ``"fused_queue"`` (``utils/profiling.counter_totals``), which
``render_radiance_jit`` fills with a device clone of 2b's stats after each
multi-block render made while the profiler records.  An entry is offered
for each sub-tile holding a triangle of each queued (ray, block) pair, and
kept where the ray enters the sub-tile's box no farther than the best hit
its select knew; a kept entry costs its sub-tile's pair tests.  Nothing
where the record is empty, offers no entry, or has no such slots (a program
whose test phase tests every triangle of a queued block)."""


def read(run):
    if run.trace is None:
        return None
    try:
        from ensem3a_openclraytracer_tpu_torch.utils.profiling import counter_totals
    except ImportError:
        return None
    totals = counter_totals("fused_queue")
    if not totals or "subtiles_tested" not in totals or not totals.get("subtiles_offered"):
        return None
    return 100.0 * totals["subtiles_tested"] / totals["subtiles_offered"]
