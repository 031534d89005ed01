"""Dataflow DAG utilities.

Pipeline graphs are declared as S-expression strings, e.g.
``"(a (b d) (c d))"`` meaning a fans out to b and c, both of which feed d
(reference: src/aiko_services/main/utilities/graph.py:41-183).  This module
provides parsing, deterministic DFS scheduling (``get_path``), resume-after
iteration for paused/looped execution, and per-edge properties used for
input/output name mapping.
"""

from __future__ import annotations

from typing import Callable, Iterable

from .sexpr import parse_value

__all__ = ["Graph", "Node", "GraphError"]


class GraphError(ValueError):
    pass


class Node:
    def __init__(self, name: str, element=None, properties: dict | None = None):
        self.name = name
        self.element = element
        self.properties = properties or {}
        self.successors: list["Node"] = []
        self._owner: "Graph | None" = None     # for path-cache invalidation

    def add_successor(self, node: "Node"):
        if node not in self.successors:
            self.successors.append(node)
            if self._owner is not None:
                self._owner._path_cache.clear()

    def __repr__(self):
        return (f"Node({self.name} -> "
                f"{[s.name for s in self.successors]})")


def path_local_remote(name: str) -> tuple[str, str]:
    """Split ``"local:remote"`` composite node names used when a subgraph
    node refers to a path inside a remote pipeline."""
    local, _, remote = name.partition(":")
    return local, (remote or local)


class Graph:
    """Directed graph with named nodes, insertion-ordered."""

    def __init__(self, heads: list[str] | None = None):
        self._nodes: dict[str, Node] = {}
        self._heads: list[str] = list(heads or [])
        # get_path is O(V^2) worst case and pipelines call it per frame;
        # graphs are immutable after construction, so memoize per head.
        # Invalidated by add_node/_ensure (the construction entry points).
        self._path_cache: dict[str, list[Node]] = {}

    # -- construction ------------------------------------------------------

    @classmethod
    def traverse(cls, graph_definition: Iterable[str],
                 node_properties: dict | None = None) -> "Graph":
        """Build a graph from one or more S-expression path strings.

        ``node_properties`` optionally maps node name -> properties dict
        (e.g. input name mappings declared per edge in the definition).
        """
        graph = cls()
        for expression in graph_definition:
            term = parse_value(expression)
            if isinstance(term, str):
                term = [term]
            if not isinstance(term, list) or not term:
                raise GraphError(f"bad graph expression: {expression!r}")
            head_name = graph._add_subtree(term, node_properties or {})
            if head_name not in graph._heads:
                graph._heads.append(head_name)
        return graph

    def _add_subtree(self, term, node_properties: dict) -> str:
        """term = [head, succ...] where each succ is a name or nested list.
        Returns the head node's name."""
        head = term[0]
        if not isinstance(head, str):
            raise GraphError(f"graph head must be a symbol: {head!r}")
        head_node = self._ensure(head, node_properties)
        for successor in term[1:]:
            if isinstance(successor, dict):
                # Inline properties for this node, e.g. input name mappings:
                # "(A (B (x: a)))" attaches {"x": "a"} to node B.
                head_node.properties = {**(head_node.properties or {}),
                                        **successor}
                continue
            if isinstance(successor, str):
                succ_name = successor
                self._ensure(succ_name, node_properties)
            elif isinstance(successor, list):
                succ_name = self._add_subtree(successor, node_properties)
            else:
                raise GraphError(f"bad graph successor: {successor!r}")
            head_node.add_successor(self._nodes[succ_name])
        return head

    def _ensure(self, name: str, node_properties: dict) -> Node:
        self._path_cache.clear()
        if name not in self._nodes:
            node = Node(name, properties=node_properties.get(name))
            node._owner = self
            self._nodes[name] = node
        return self._nodes[name]

    def add_node(self, name: str, element=None, properties=None) -> Node:
        node = self._ensure(name, {})
        if element is not None:
            node.element = element
        if properties is not None:
            node.properties = properties
        if not self._heads:
            self._heads.append(name)
        return node

    # -- access ------------------------------------------------------------

    def __contains__(self, name: str) -> bool:
        return name in self._nodes

    def __len__(self) -> int:
        return len(self._nodes)

    def get_node(self, name: str) -> Node:
        return self._nodes[name]

    def nodes(self) -> list[Node]:
        return list(self._nodes.values())

    def node_names(self) -> list[str]:
        return list(self._nodes)

    @property
    def heads(self) -> list[Node]:
        return [self._nodes[h] for h in self._heads]

    # -- scheduling --------------------------------------------------------

    def get_path(self, head: str | None = None) -> list[Node]:
        """Deterministic execution order: topological, with declaration
        (DFS-preorder) order breaking ties.

        The reference scheduler walks plain DFS preorder
        (graph.py:59-79), which runs a fan-in node when FIRST reached --
        before its remaining producers -- so in ``(a (b d) (c d))`` the
        merge node d executes before c and can only see b's inputs.
        Correct dataflow requires every producer to run first; here d
        always runs after both b and c.
        """
        if head is None:
            if not self._heads:
                return []
            head = self._heads[0]
        cached = self._path_cache.get(head)
        if cached is not None:
            return list(cached)
        preorder: list[Node] = []
        seen: set[str] = set()

        def visit(node: Node):
            if node.name in seen:
                return
            seen.add(node.name)
            preorder.append(node)
            for successor in node.successors:
                visit(successor)

        visit(self._nodes[head])

        # Kahn's algorithm restricted to reachable nodes, always taking
        # the earliest ready node in declaration order.
        reachable = {node.name for node in preorder}
        order: list[Node] = []
        emitted: set[str] = set()
        remaining = list(preorder)
        while remaining:
            for index, node in enumerate(remaining):
                ready = all(p.name in emitted
                            for p in self.predecessors(node.name)
                            if p.name in reachable)
                if ready:
                    emitted.add(node.name)
                    order.append(node)
                    del remaining[index]
                    break
            else:      # cycle among remaining: fall back to declaration
                order.extend(remaining)
                break
        self._path_cache[head] = order
        return list(order)

    def iterate_after(self, name: str, head: str | None = None) -> list[Node]:
        """Nodes strictly after ``name`` in the execution path -- used to
        resume a paused frame after a remote stage or loop-back."""
        path = self.get_path(head)
        for index, node in enumerate(path):
            if node.name == name:
                return path[index + 1:]
        raise GraphError(f"node not in path: {name}")

    def predecessors(self, name: str) -> list[Node]:
        return [n for n in self._nodes.values()
                if any(s.name == name for s in n.successors)]

    def validate_acyclic(self):
        """Raise GraphError on cycles (explicit Loop elements re-enter the
        path via iterate_after instead of graph cycles)."""
        WHITE, GREY, BLACK = 0, 1, 2
        color = {name: WHITE for name in self._nodes}

        def visit(node: Node):
            color[node.name] = GREY
            for successor in node.successors:
                if color[successor.name] == GREY:
                    raise GraphError(f"cycle through {successor.name}")
                if color[successor.name] == WHITE:
                    visit(successor)
            color[node.name] = BLACK

        for name in self._nodes:
            if color[name] == WHITE:
                visit(self._nodes[name])

    def __repr__(self):
        return f"Graph(heads={self._heads}, nodes={list(self._nodes)})"
