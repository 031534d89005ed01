"""Expression elements: define/delete/rename swag values with a small
safe expression language (reference: src/aiko_services/elements/utilities/
elements.py:25-140)."""

from __future__ import annotations

import ast as python_ast
import operator

from ..pipeline import PipelineElement, StreamEvent

__all__ = ["Expression", "AllOutputs", "evaluate_expression"]

_BIN_OPS = {
    python_ast.Add: operator.add, python_ast.Sub: operator.sub,
    python_ast.Mult: operator.mul, python_ast.Div: operator.truediv,
    python_ast.FloorDiv: operator.floordiv, python_ast.Mod: operator.mod,
    python_ast.Pow: operator.pow,
}
_CMP_OPS = {
    python_ast.Eq: operator.eq, python_ast.NotEq: operator.ne,
    python_ast.Lt: operator.lt, python_ast.LtE: operator.le,
    python_ast.Gt: operator.gt, python_ast.GtE: operator.ge,
}


def evaluate_expression(text: str, variables: dict):
    """Safe arithmetic/comparison evaluator over swag variables -- no
    attribute access, no calls, no subscripts."""
    tree = python_ast.parse(str(text), mode="eval")

    def walk(node):
        if isinstance(node, python_ast.Expression):
            return walk(node.body)
        if isinstance(node, python_ast.Constant):
            return node.value
        if isinstance(node, python_ast.Name):
            if node.id in variables:
                value = variables[node.id]
                try:
                    return float(value) if isinstance(value, str) else value
                except ValueError:
                    return value
            raise NameError(node.id)
        if isinstance(node, python_ast.BinOp) \
                and type(node.op) in _BIN_OPS:
            return _BIN_OPS[type(node.op)](walk(node.left),
                                           walk(node.right))
        if isinstance(node, python_ast.UnaryOp) \
                and isinstance(node.op, python_ast.USub):
            return -walk(node.operand)
        if isinstance(node, python_ast.Compare) and len(node.ops) == 1 \
                and type(node.ops[0]) in _CMP_OPS:
            return _CMP_OPS[type(node.ops[0])](walk(node.left),
                                               walk(node.comparators[0]))
        if isinstance(node, python_ast.BoolOp):
            values = [walk(v) for v in node.values]
            return (all(values) if isinstance(node.op, python_ast.And)
                    else any(values))
        raise ValueError(f"unsupported expression node: "
                         f"{type(node).__name__}")

    return walk(tree)


class Expression(PipelineElement):
    """``expressions`` parameter: list of ``name = expr`` / ``name := expr``
    (define), ``del name`` (delete), ``new = old`` (rename via define+del
    is explicit).  Expressions see the frame's bare swag names."""

    def process_frame(self, stream, **inputs):
        expressions, found = self.get_parameter("expressions")
        if not found:
            return StreamEvent.OKAY, {}
        if isinstance(expressions, str):
            expressions = [e.strip() for e in expressions.split(";")
                           if e.strip()]
        frame = stream.frames.get(max(stream.frames)) \
            if stream.frames else None
        swag = {k: v for k, v in (frame.swag if frame else inputs).items()
                if "." not in k}
        outputs = {}
        for expression in expressions:
            try:
                if expression.startswith("del "):
                    name = expression[4:].strip()
                    if frame is not None:
                        frame.swag.pop(name, None)
                    swag.pop(name, None)
                    continue
                name, _, rhs = expression.partition("=")
                name = name.rstrip(":").strip()
                value = evaluate_expression(rhs.strip(), swag)
                swag[name] = value
                outputs[name] = value
            except Exception as error:
                return StreamEvent.ERROR, {
                    "diagnostic": f"{expression!r}: {error}"}
        return StreamEvent.OKAY, outputs


class AllOutputs(PipelineElement):
    """Emits the whole bare-name swag as outputs (reference
    utilities/elements.py:25-46)."""

    def process_frame(self, stream, **inputs):
        frame = stream.frames.get(max(stream.frames)) \
            if stream.frames else None
        swag = frame.swag if frame else inputs
        return StreamEvent.OKAY, \
            {k: v for k, v in swag.items() if "." not in k}
