"""repro_torch.core — the paper's contribution: a fusion compiler for
map/reduce elementary functions, emitting CUDA for Hopper."""
from ..kernels._launch import LAUNCHES
from .cache import CacheStats, PlanCache, default_cache
from .codegen import CompiledProgram, compile_plan, execute_dense
from .compiler import MODES, FusionCompiler
from .cuda_codegen import GroupKernel, tiled_reference
from .elementary import (ArgSpec, Elementary, Kind, Monoid, make_map,
                         make_nested_map, make_nested_map_reduce, make_reduce)
from .fusion import Fusion, analyse_group, enumerate_fusions, saves_traffic
from .graph import CallNode, Graph, Var, trace
from .plan import (ExecutionPlan, GroupPlan, build_plan, graph_signature,
                   group_signature, plan_from_reference)
from .predictor import V5E, HardwareModel, Impl, enumerate_impls
from .scheduler import (Combination, OptimizationSpace, best_combination,
                        build_space, enumerate_combinations,
                        iter_combinations, unfused_combination)

__all__ = [
    "ArgSpec", "CacheStats", "CallNode", "Combination", "CompiledProgram",
    "Elementary", "ExecutionPlan", "Fusion", "FusionCompiler", "Graph",
    "GroupKernel", "GroupPlan", "HardwareModel", "Impl", "Kind", "LAUNCHES",
    "MODES", "Monoid", "OptimizationSpace", "PlanCache", "V5E", "Var",
    "analyse_group", "best_combination", "build_plan", "build_space",
    "compile_plan", "default_cache", "enumerate_combinations",
    "enumerate_fusions", "enumerate_impls", "execute_dense",
    "graph_signature", "group_signature", "iter_combinations", "make_map",
    "make_nested_map", "make_nested_map_reduce", "make_reduce",
    "plan_from_reference", "saves_traffic", "tiled_reference", "trace",
    "unfused_combination",
]
