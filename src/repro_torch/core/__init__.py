"""repro_torch.core — the paper's contribution: a fusion compiler for
map/reduce elementary functions, emitting CUDA for Hopper."""
from ..kernels._launch import LAUNCHES
from .cache import BucketStats, CacheStats, PlanCache, default_cache
from .codegen import (BatchedProgram, CompiledProgram, PackedDispatch,
                      PackedProgram, compile_combination, compile_plan,
                      compile_plan_batched, compile_plan_packed,
                      execute_dense)
from .compiler import MODES, CompileReport, FusionCompiler
from .cuda_codegen import GroupKernel, tiled_reference
from .elementary import (ArgSpec, Elementary, Kind, Monoid, make_map,
                         make_nested_map, make_nested_map_reduce, make_reduce,
                         make_tensor_map)
from .fusion import Fusion, analyse_group, enumerate_fusions, saves_traffic
from .graph import CallNode, Graph, Var, trace
from .graphs import GraphRunner
from .masking import (MASK_INPUT, MaskedTrace, mask_elementary, mask_row,
                      masked_wrapper, padded_dims)
from .plan import (ExecutionPlan, GroupPlan, PackedPlan, build_packed_plan,
                   build_plan, canonical_pack_order, graph_signature,
                   group_signature, pack_signature, plan_fingerprint,
                   plan_from_reference)
from .predictor import V5E, HardwareModel, Impl, enumerate_impls
from .scheduler import (Combination, OptimizationSpace, best_combination,
                        build_space, enumerate_combinations,
                        exhaustive_best_combination, iter_combinations,
                        unfused_combination)

__all__ = [
    "ArgSpec", "BatchedProgram", "BucketStats", "CacheStats", "CallNode",
    "Combination", "CompileReport", "CompiledProgram", "Elementary",
    "ExecutionPlan", "Fusion", "FusionCompiler", "Graph", "GraphRunner",
    "GroupKernel", "GroupPlan", "HardwareModel", "Impl", "Kind", "LAUNCHES",
    "MASK_INPUT", "MODES", "MaskedTrace", "Monoid", "OptimizationSpace",
    "PackedDispatch", "PackedPlan", "PackedProgram", "PlanCache", "V5E",
    "Var", "analyse_group", "best_combination", "build_packed_plan",
    "build_plan", "build_space", "canonical_pack_order",
    "compile_combination", "compile_plan", "compile_plan_batched",
    "compile_plan_packed", "default_cache", "enumerate_combinations",
    "enumerate_fusions", "enumerate_impls", "execute_dense",
    "exhaustive_best_combination", "graph_signature", "group_signature",
    "iter_combinations", "make_map", "make_nested_map",
    "make_nested_map_reduce", "make_reduce", "make_tensor_map",
    "mask_elementary", "mask_row", "masked_wrapper", "pack_signature",
    "padded_dims", "plan_fingerprint", "plan_from_reference",
    "saves_traffic", "tiled_reference", "trace", "unfused_combination",
]
