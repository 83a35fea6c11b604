"""Distribution on ``torch.distributed`` (counterpart of
``repro.distributed``): meshes of ranks and the LM's sharding rules
(``sharding``: ``Mesh``, ``make_mesh``, ``get_mesh``, ``Axes``,
``tree_shardings``), the collectives (``collectives``: the sDTW
pipeline's hand-off and harvest, int8 gradient compression and
``compressed_psum``), GPipe over layers (``pipeline``) and the sharded
sDTW engine with its entry points (``sdtw_sharded``)."""
from .sharding import (Axes, Mesh, get_mesh, init_multi_host, make_mesh,
                       pipeline_axes, tree_shardings)

__all__ = ["Axes", "Mesh", "get_mesh", "init_multi_host", "make_mesh",
           "pipeline_axes", "tree_shardings", "sdtw_sharded",
           "sdtw_sharded_feed", "build_pipeline", "make_schedule",
           "PipelineSchedule", "clear_pipeline_cache", "default_mesh"]

_SDTW_NAMES = ("sdtw_sharded", "sdtw_sharded_feed", "build_pipeline",
               "make_schedule", "PipelineSchedule", "clear_pipeline_cache",
               "default_mesh")


def __getattr__(name):
    # Lazy, as in the reference: the sharded engine pulls in
    # repro_torch.core, and core.engine imports this package lazily too.
    # Resolved names are pinned into globals() so ``sdtw_sharded`` (named
    # like its submodule) stays the function on repeat access.
    if name in _SDTW_NAMES:
        import importlib
        mod = importlib.import_module(".sdtw_sharded", __name__)
        val = getattr(mod, name)
        globals()[name] = val
        return val
    raise AttributeError(name)
