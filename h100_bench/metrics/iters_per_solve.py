"""Mean ``SolveResult.iterations`` of the window's solves."""


def read(obs):
    calls = obs["calls"]
    return sum(c["iterations"] for c in calls) / len(calls)
