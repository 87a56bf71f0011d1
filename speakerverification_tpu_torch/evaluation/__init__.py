"""Trial evaluation: scoring, metrics, reports, the evaluator."""
