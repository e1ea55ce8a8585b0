"""idle_share.resolve: ``idle_share.refactor``'s reader, over the traced
solves of a resolve cell."""
from benchmark import harness

read = harness.load_metric("idle_share.refactor").read
