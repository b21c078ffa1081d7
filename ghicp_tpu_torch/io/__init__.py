"""Cloud files (numpy and the native runtime) and synthetic scenes and
pairs (numpy only)."""
from ghicp_tpu_torch.io.files import (read_cloud, read_las, read_pcd,
                                      read_ply, read_txt, write_cloud,
                                      write_las, write_pcd, write_ply,
                                      write_txt)
from ghicp_tpu_torch.io.synthetic import make_pair, structured_scene

__all__ = [
    "read_cloud", "read_las", "read_pcd", "read_ply", "read_txt",
    "write_cloud", "write_las", "write_pcd", "write_ply", "write_txt",
    "make_pair", "structured_scene",
]
