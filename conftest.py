# Directories that .gitignore lists hold scratch copies of the repo (a parent
# checkout for chip comparisons, a copy of the committed tree); their tests
# would shadow the repo's own modules of the same name, so never collect them.
collect_ignore = ["chipwork", "chiprun_out", "build"]
