"""Plain references of the configurations, independent of the program: a
configuration's file names its module here under ``reference``."""
