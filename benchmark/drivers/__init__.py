"""The traffic drivers, one module a kind of traffic, named by a traffic
file's ``driver``."""
