"""Idle device ms a query while its template prompts are formatted and
tokenised on the host: the port's ``query.tokenize`` range."""

from portbench.trace import idle


def read(view):
    return idle.per_count_ms(view, ("query.tokenize",), "queries")
