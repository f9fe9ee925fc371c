"""The SLO engine's file name (copied from ``adam_tpu/utils/slo.py``):
``analyzer.analyze_path`` folds a ``SLO_BUDGET.json`` that sits beside an
artifact into its "SLO" section.

Arming objectives and charging the error budget come with ROADMAP queue
1 item 5.
"""

#: Durable budget file name under the run root.
BUDGET_FILENAME = "SLO_BUDGET.json"
