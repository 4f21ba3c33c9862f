"""Planner, cost model and hybrid-SGD execution engine of the port."""
