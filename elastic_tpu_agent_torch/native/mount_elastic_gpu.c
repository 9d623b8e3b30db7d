/* mount_elastic_gpu: attach a card node to a RUNNING container.
 *
 * The port's counterpart of the agent's native/mount_elastic_tpu.c: stat the
 * host node (e.g. /dev/nvidia3) in the host's mount namespace, carry its
 * major:minor across setns into the target pid's mount namespace and mknod
 * it there; where mknod is refused (a nodev filesystem), bind-mount the host
 * node through an fd opened before the setns.
 *
 * Usage: mount_elastic_gpu <pid> <host-dev-path> <container-dev-path>
 *   e.g. mount_elastic_gpu 12345 /dev/nvidia3 /dev/nvidia3
 */
#define _GNU_SOURCE
#include <errno.h>
#include <fcntl.h>
#include <sched.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/mount.h>
#include <sys/stat.h>
#include <sys/sysmacros.h>
#include <sys/types.h>
#include <unistd.h>

static void die(const char *what) {
  fprintf(stderr, "mount_elastic_gpu: %s: %s\n", what, strerror(errno));
  exit(1);
}

int main(int argc, char **argv) {
  if (argc != 4) {
    fprintf(stderr,
            "usage: mount_elastic_gpu <pid> <host-dev-path> "
            "<container-dev-path>\n");
    return 2;
  }
  const char *pid = argv[1];
  const char *source = argv[2];
  const char *target = argv[3];

  /* The device's identity, read in the host's namespace. */
  struct stat st;
  if (stat(source, &st) != 0) die("stat source");
  int is_chardev = S_ISCHR(st.st_mode);

  /* A host-namespace fd of the source for the bind fallback. */
  int srcfd = open(source, O_PATH | O_CLOEXEC);
  if (srcfd < 0) die("open source");

  char nspath[64];
  snprintf(nspath, sizeof(nspath), "/proc/%s/ns/mnt", pid);
  int nsfd = open(nspath, O_RDONLY | O_CLOEXEC);
  if (nsfd < 0) die("open mount namespace");
  if (setns(nsfd, CLONE_NEWNS) != 0) die("setns");
  close(nsfd);

  if (is_chardev) {
    if (mknod(target, S_IFCHR | 0666, st.st_rdev) == 0) {
      printf("mknod %s (dev %u:%u)\n", target, major(st.st_rdev),
             minor(st.st_rdev));
      return 0;
    }
    if (errno == EEXIST) {
      struct stat cur;
      if (lstat(target, &cur) == 0 && S_ISCHR(cur.st_mode) &&
          cur.st_rdev == st.st_rdev) {
        printf("%s already present\n", target);
        return 0;
      }
    }
    fprintf(stderr, "mount_elastic_gpu: mknod %s: %s; trying bind\n", target,
            strerror(errno));
  }

  /* The bind fallback through the host-namespace fd's magic link. */
  int tfd = open(target, O_CREAT | O_WRONLY | O_CLOEXEC, 0666);
  if (tfd >= 0) close(tfd);
  char fdpath[64];
  snprintf(fdpath, sizeof(fdpath), "/proc/self/fd/%d", srcfd);
  if (mount(fdpath, target, NULL, MS_BIND, NULL) != 0) die("bind mount");
  printf("bind %s -> %s\n", source, target);
  return 0;
}
