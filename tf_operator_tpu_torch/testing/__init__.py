"""Workloads the process e2e tier launches under the operator."""
