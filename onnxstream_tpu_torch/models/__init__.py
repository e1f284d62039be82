"""Model zoo: architecture graphs built on the GraphBuilder DSL."""
