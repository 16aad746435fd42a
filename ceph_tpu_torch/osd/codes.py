"""Op result codes shared by the OSD op interpreter and the client stack
(errno-style, matching librados return conventions).

Counterpart of ceph_tpu/osd/codes.py: the same module over the
port's imports."""

OK = 0
ENOENT_RC = -2
EIO_RC = -5
EAGAIN_RC = -11
EINVAL_RC = -22
ENOTSUP_RC = -95
ESTALE_RC = -116              # sub-op from an older PG interval, dropped
EBLOCKLISTED_RC = -108        # client instance fenced by the OSDMap
EDQUOT_RC = -122              # pool quota exceeded (FULL_QUOTA)
MISDIRECTED_RC = -1000        # resend after map refresh (reference drops)
EPERM_RC = -1               # operation not permitted (caps)

# op kinds that never mutate — ONE definition shared by the OSD op
# interpreter (dedup/replay classification) and the client Objecter
# (cache-tier read/write routing); pgls is a read-class special op
READ_OPS = frozenset({"read", "stat", "getxattr", "getxattrs",
                      "omap_get"})
# ...including the read-class special ops (caps + client-side routing)
READ_CLASS_OPS = READ_OPS | {"pgls"}
