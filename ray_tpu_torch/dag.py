"""DAG API: lazily bound task and actor graphs (port of ray_tpu/dag.py).

``.bind()`` on a remote function, an actor class or an actor method
builds a node instead of submitting; ``execute()`` walks the graph and
submits every node once, passing each upstream ObjectRef straight into
the downstream call's arguments (no get in the driver), so successive
executions pipeline. ``experimental_compile()`` validates the topology
once and creates the graph's actors once; with ``channels=True`` the
graph runs over persistent shared-memory rings
(``ray_tpu_torch.experimental.compiled_dag``) and the head leaves the
steady-state loop.
"""

from __future__ import annotations

from ray_tpu_torch.core.object_ref import ObjectRef


class DAGNode:
    def __init__(self, args: tuple, kwargs: dict):
        self._bound_args = args
        self._bound_kwargs = kwargs

    def _resolve(self, v, memo: dict):
        if isinstance(v, DAGNode):
            return v._execute_memo(memo)
        if isinstance(v, (list, tuple)):
            return type(v)(self._resolve(x, memo) for x in v)
        if isinstance(v, dict):
            return {k: self._resolve(x, memo) for k, x in v.items()}
        return v

    def _resolved_args(self, memo: dict):
        args = tuple(self._resolve(a, memo) for a in self._bound_args)
        kwargs = {k: self._resolve(v, memo) for k, v in self._bound_kwargs.items()}
        return args, kwargs

    def _execute_memo(self, memo: dict):
        if id(self) not in memo:
            memo[id(self)] = self._execute_impl(memo)
        return memo[id(self)]

    def execute(self, *input_args):
        """Run the DAG; InputNode placeholders are filled positionally."""
        memo = {"__inputs__": input_args}
        return self._execute_memo(memo)

    def experimental_compile(self, *, channels: bool = False, nslots: int = 8, buffer_size_bytes: int = 256 << 10):
        """Compile this DAG for repeated execution: topology validated and
        actors created once. ``channels=True`` compiles to persistent
        shm-ring channels with an execution loop in each actor
        (``ray_tpu_torch.experimental.compiled_dag``; actor-method DAGs on
        one host)."""
        if channels:
            from ray_tpu_torch.experimental.compiled_dag import ChannelCompiledDAG

            return ChannelCompiledDAG(self, nslots=nslots, buffer_size_bytes=buffer_size_bytes)
        return CompiledDAG(self)

    def _execute_impl(self, memo):  # pragma: no cover - abstract
        raise NotImplementedError


class InputNode(DAGNode):
    """Placeholder for execute()-time arguments."""

    _counter = 0

    def __init__(self, index: int | None = None):
        super().__init__((), {})
        if index is None:
            index = InputNode._counter
            InputNode._counter += 1
        self.index = index

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        InputNode._counter = 0
        return False

    def _execute_impl(self, memo):
        return memo["__inputs__"][self.index]


class FunctionNode(DAGNode):
    def __init__(self, remote_fn, args, kwargs):
        super().__init__(args, kwargs)
        self._remote_fn = remote_fn

    def _execute_impl(self, memo) -> ObjectRef:
        args, kwargs = self._resolved_args(memo)
        return self._remote_fn.remote(*args, **kwargs)


class ClassNode(DAGNode):
    def __init__(self, actor_cls, args, kwargs):
        super().__init__(args, kwargs)
        self._actor_cls = actor_cls
        self._handle = None

    def _execute_impl(self, memo):
        if self._handle is None:
            args, kwargs = self._resolved_args(memo)
            self._handle = self._actor_cls.remote(*args, **kwargs)
        return self._handle

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return _ClassMethodBinder(self, name)


class _ClassMethodBinder:
    def __init__(self, class_node: ClassNode, method: str):
        self._class_node = class_node
        self._method = method

    def bind(self, *args, **kwargs):
        return ClassMethodNode(self._class_node, self._method, args, kwargs)


class ClassMethodNode(DAGNode):
    def __init__(self, class_node: ClassNode, method: str, args, kwargs):
        super().__init__(args, kwargs)
        self._class_node = class_node
        self._method = method

    def _execute_impl(self, memo) -> ObjectRef:
        handle = self._class_node._execute_memo(memo)
        args, kwargs = self._resolved_args(memo)
        return getattr(handle, self._method).remote(*args, **kwargs)


class ActorMethodNode(DAGNode):
    """bind() on an already-created actor handle's method."""

    def __init__(self, handle, method: str, args, kwargs):
        super().__init__(args, kwargs)
        self._handle = handle
        self._method = method

    def _execute_impl(self, memo) -> ObjectRef:
        args, kwargs = self._resolved_args(memo)
        return getattr(self._handle, self._method).remote(*args, **kwargs)


def topo_order(leaves: list) -> list[DAGNode]:
    """The DAG's nodes in dependency order (each after everything it
    consumes); ValueError on a cycle."""
    schedule: list[DAGNode] = []
    seen: dict[int, int] = {}  # id -> 0 visiting, 1 done

    def visit(node):
        if isinstance(node, (list, tuple)):
            for x in node:
                visit(x)
            return
        if isinstance(node, dict):
            for x in node.values():
                visit(x)
            return
        if not isinstance(node, DAGNode):
            return
        st = seen.get(id(node))
        if st == 1:
            return
        if st == 0:
            raise ValueError("cycle detected in DAG")
        seen[id(node)] = 0
        deps = list(node._bound_args) + list(node._bound_kwargs.values())
        if isinstance(node, ClassMethodNode):
            deps.append(node._class_node)
        for d in deps:
            visit(d)
        seen[id(node)] = 1
        schedule.append(node)

    for lf in leaves:
        visit(lf)
    return schedule


class CompiledDAG:
    """Compiled execution over a validated DAG topology.

    Compile time: walk the graph once, detect cycles, record a
    dependency-ordered schedule, and create every ClassNode's actor whose
    arguments are static (replays reuse warm actors). Execute time: fill
    the InputNodes positionally and submit every node along the schedule
    in one pass; returns the leaf's ObjectRef (or a list of them for
    MultiOutputNode leaves)."""

    def __init__(self, leaf):
        self._leaves = list(leaf) if isinstance(leaf, list) else [leaf]
        self._schedule = topo_order(self._leaves)
        input_indices = {n.index for n in self._schedule if isinstance(n, InputNode)}
        self.num_inputs = (max(input_indices) + 1) if input_indices else 0
        boot_memo: dict = {"__inputs__": ()}
        for node in self._schedule:
            if isinstance(node, ClassNode) and not any(
                isinstance(a, DAGNode) for a in list(node._bound_args) + list(node._bound_kwargs.values())
            ):
                node._execute_memo(boot_memo)

    def execute(self, *input_args):
        if len(input_args) < self.num_inputs:
            raise ValueError(f"compiled DAG takes {self.num_inputs} inputs, got {len(input_args)}")
        memo = {"__inputs__": input_args}
        for node in self._schedule:
            node._execute_memo(memo)
        outs = [memo[id(lf)] for lf in self._leaves]
        return outs if len(outs) > 1 else outs[0]

    def teardown(self):
        """Kill the compile-time actors."""
        import ray_tpu_torch

        for node in self._schedule:
            if isinstance(node, ClassNode) and node._handle is not None:
                ray_tpu_torch.kill(node._handle)
                node._handle = None


MultiOutputNode = list  # wraps several leaf nodes


def compile_dag(leaf_or_leaves) -> CompiledDAG:
    """Compile a DAG leaf (or a MultiOutputNode list of leaves)."""
    return CompiledDAG(leaf_or_leaves)
