"""What a captured CUDA graph launches, read through libcuda's graph
calls, independent of any profiler.

``kernel_names(graph)`` lists the function names of a kept graph's
kernel nodes (C++ names demangled), and ``graph_nodes`` counts its nodes
by type and the kernel nodes whose names hold given strings. A graph
node is a launch a replay makes, so these counts are exact where a
profiler's records can be lost. The graph must be kept after
instantiation (``serving.macro.capture`` keeps it). Nothing here runs at
import.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Sequence, Tuple

__all__ = ["kernel_names", "graph_nodes"]


class _KernelNodeParams(ctypes.Structure):     # CUDA_KERNEL_NODE_PARAMS_v2
    _fields_ = [("func", ctypes.c_void_p),
                ("dims", ctypes.c_uint * 7),     # grid, block, shared bytes
                ("kernel_params", ctypes.c_void_p),
                ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p),
                ("ctx", ctypes.c_void_p)]


_KINDS = {0: "kernel", 1: "memcpy", 2: "memset"}


@functools.lru_cache(maxsize=None)
def _cxx():
    """(__cxa_demangle, free) from libstdc++ and libc."""
    demangle = ctypes.CDLL("libstdc++.so.6").__cxa_demangle
    demangle.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
                         ctypes.POINTER(ctypes.c_int)]
    demangle.restype = ctypes.c_void_p
    free = ctypes.CDLL(None).free
    free.argtypes = [ctypes.c_void_p]
    return demangle, free


@functools.lru_cache(maxsize=None)
def _demangle(name: str) -> str:
    """The C++ name of a mangled symbol (libstdc++'s __cxa_demangle);
    the name itself when it is not mangled (an extern "C" kernel)."""
    if not name.startswith("_Z"):
        return name
    demangle, free = _cxx()
    status = ctypes.c_int(-1)
    ptr = demangle(name.encode(), None, None, ctypes.byref(status))
    if status.value != 0 or not ptr:
        return name
    try:
        return ctypes.string_at(ptr).decode()
    finally:
        free(ptr)


def _nodes(graph) -> Tuple[ctypes.CDLL, List[ctypes.c_void_p]]:
    cuda = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(handle, None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if n.value and cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    return cuda, [ctypes.c_void_p(p) for p in nodes]


def _node_type(cuda, node) -> str:
    kind = ctypes.c_int(-1)
    if cuda.cuGraphNodeGetType(node, ctypes.byref(kind)):
        raise RuntimeError("cuGraphNodeGetType failed")
    return _KINDS.get(kind.value, "other")


def _kernel_name(cuda, node) -> str:
    p = _KernelNodeParams()
    if cuda.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(p)):
        raise RuntimeError("cuGraphKernelNodeGetParams failed")
    fname = ctypes.c_char_p()
    err = (cuda.cuFuncGetName(ctypes.byref(fname), ctypes.c_void_p(p.func))
           if p.func else
           cuda.cuKernelGetName(ctypes.byref(fname), ctypes.c_void_p(p.kern)))
    if err or not fname.value:
        raise RuntimeError(
            f"no name for a kernel node of a graph (CUresult {err})")
    return _demangle(fname.value.decode())


def kernel_names(graph) -> List[str]:
    """The (demangled) function name of every kernel node of a kept
    graph, in node order."""
    cuda, nodes = _nodes(graph)
    return [_kernel_name(cuda, nd) for nd in nodes
            if _node_type(cuda, nd) == "kernel"]


def graph_nodes(graph, names: Sequence[str] = ()
                ) -> Tuple[Dict[str, int], Dict[str, int]]:
    """({node type: count} over kernel, memcpy, memset and other nodes,
    {name: kernel nodes whose function name holds it} for each of
    ``names``) of one kept graph: what one replay launches."""
    cuda, nodes = _nodes(graph)
    types: Dict[str, int] = {}
    named = {name: 0 for name in names}
    for nd in nodes:
        key = _node_type(cuda, nd)
        types[key] = types.get(key, 0) + 1
        if key == "kernel" and names:
            fname = _kernel_name(cuda, nd)
            for name in names:
                named[name] += name in fname
    return types, named
