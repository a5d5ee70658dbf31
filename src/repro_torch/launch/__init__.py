"""Launchers: serve-step builders (``serve``), train-step builders
(``train``) and the Datalog query-serving request loop (``query_serve``)."""
