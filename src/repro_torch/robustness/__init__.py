"""Solver guardrails and tag-escalation recovery."""
