"""User-level async DB wrappers (reference ``ext/db``: ``gwredis.go``,
``gwmongo.go:31-355`` — async groups wrapping redigo/mgo with callbacks
posted back to the logic thread)."""
