"""Native (C++) host components, built with g++ at first use and loaded
through ctypes.  `invfile` is the place-recognition postings index that
`models.kfdb.KeyFrameDatabase` uses by default; a failed build raises with
the compiler's message (there is no quiet fallback)."""
