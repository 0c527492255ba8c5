"""Interpreter-path operands (the ``tm_interp`` kernel is not ported yet)."""

from .ops import plan_to_operands

__all__ = ["plan_to_operands"]
