"""Model-format tooling: the GraphBuilder DSL."""
