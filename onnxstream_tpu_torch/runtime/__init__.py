"""Runtime: session, planner, executor, weight providers, attention fusion."""
