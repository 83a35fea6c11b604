"""The sharded sDTW engine on ``torch.distributed`` (counterpart of
``repro.distributed``): meshes of ranks (``sharding``), the systolic
hand-off and harvest (``collectives``, which also holds the train step's
local int8 gradient compression) and the pipeline with its entry points
(``sdtw_sharded``). The LM stack's ``Axes``, ``tree_shardings``, GPipe
over layers (``pipeline``) and ``compressed_psum`` wait for ROADMAP item
14(b)."""
from .sharding import Mesh, get_mesh, init_multi_host, pipeline_axes

__all__ = ["Mesh", "get_mesh", "init_multi_host", "pipeline_axes",
           "sdtw_sharded", "sdtw_sharded_feed", "build_pipeline",
           "make_schedule", "PipelineSchedule", "clear_pipeline_cache",
           "default_mesh"]

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
