// elastic-gpu-container-toolkit: inject a CUDA allocation into a container
// rootfs.
//
// The port's counterpart of the agent's native/toolkit.cc, run by
// elastic-gpu-hook (the OCI hook chain; the NRI server in
// nri/plugin.py is the containerd path, and both inject the same device set
// and env for one spec):
//
//   1. Resolve the allocation hash: from the agent's allocation spec
//      (<alloc-dir>/<hash>.json, written at PreStartContainer), else by
//      scanning the agent's links <dev>/elastic-tpu-<hash>-<p> -> a card node
//      /dev/nvidia<minor>. A link to anything but nvidia<digits> (nvidiactl,
//      nvidia-uvm*, nvidia-modeset, nvidia-caps/*) is no card and is skipped;
//      the scan takes each card's uuid from <proc-root>/driver/nvidia/gpus/
//      */information ("Device Minor:", "GPU UUID:"), else (a host or
//      container that hides those files) from `nvidia-smi -q -x`
//      (<minor_number>, <uuid>), and fails without one: CUDA_VISIBLE_DEVICES
//      is never an ordinal.
//   2. mknod each card in the rootfs at its host name /dev/nvidia<minor>,
//      with the host node's rdev (the driver opens the minor the kernel
//      reports), and each control node the spec names (the scan: the
//      nvidiactl/nvidia-uvm/nvidia-uvm-tools the host holds), skipping those
//      that are gone or are no character device of a live driver (major 0).
//      A card node that is no character device fails the injection. Where
//      mknod is refused, the host node is bind-mounted instead.
//   3. Write the spec's env (CUDA_VISIBLE_DEVICES = the card's uuid, the quota
//      keys, the trace id) to /run/elastic-tpu/env as KEY=VALUE lines and
//      copy the spec to /run/elastic-tpu/alloc.json.
//   4. Copy each --driver-lib host library (libcuda.so.1, ...) to its own
//      path in the rootfs when the image lacks it: a container started
//      without nvidia-container-toolkit needs the user-space driver that
//      matches the host's kernel module.
//
// <dev> names the host's /dev as this process sees it: nodes are stat'ed
// there and named by their host paths in the rootfs.
//
// Usage:
//   elastic-gpu-container-toolkit inject --rootfs <dir> --hash <h>
//       [--alloc-dir DIR] [--dev DIR] [--proc-root DIR] [--nvidia-smi PATH]
//       [--driver-lib PATH]... [--verbose]

#include <dirent.h>
#include <errno.h>
#include <fcntl.h>
#include <limits.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/mount.h>
#include <sys/stat.h>
#include <sys/sysmacros.h>
#include <sys/types.h>
#include <sys/wait.h>
#include <unistd.h>

#include <algorithm>
#include <fstream>
#include <map>
#include <sstream>
#include <string>
#include <vector>

#include "json.h"

namespace {

bool g_verbose = false;

const char* const kControlNodes[] = {"nvidiactl", "nvidia-uvm",
                                     "nvidia-uvm-tools"};

void vlog(const std::string& msg) {
  if (g_verbose) fprintf(stderr, "elastic-gpu-toolkit: %s\n", msg.c_str());
}

std::string ReadFile(const std::string& path) {
  std::ifstream f(path);
  if (!f) return "";
  std::stringstream ss;
  ss << f.rdbuf();
  return ss.str();
}

bool MkdirP(const std::string& path, mode_t mode) {
  std::string cur;
  std::stringstream ss(path);
  std::string part;
  if (!path.empty() && path[0] == '/') cur = "/";
  while (std::getline(ss, part, '/')) {
    if (part.empty()) continue;
    cur += part + "/";
    if (mkdir(cur.c_str(), mode) != 0 && errno != EEXIST) return false;
  }
  return true;
}

std::string Dirname(const std::string& path) {
  size_t pos = path.rfind('/');
  return pos == std::string::npos ? "." : path.substr(0, pos);
}

std::string Basename(const std::string& path) {
  size_t pos = path.rfind('/');
  return pos == std::string::npos ? path : path.substr(pos + 1);
}

// The minor of a card node's name "nvidia<digits>", else -1: a control
// node (nvidiactl, nvidia-uvm, nvidia-modeset, nvidia-caps/...) is no card.
int CardMinor(const std::string& name) {
  if (name.rfind("nvidia", 0) != 0 || name.size() == 6) return -1;
  for (size_t i = 6; i < name.size(); i++)
    if (name[i] < '0' || name[i] > '9') return -1;
  return atoi(name.c_str() + 6);
}

struct AllocSpec {
  std::vector<std::string> device_paths;   // host card nodes
  std::vector<std::string> control_paths;  // host control nodes
  std::map<std::string, std::string> env;
  bool valid = false;
};

AllocSpec SpecFromFile(const std::string& path) {
  AllocSpec spec;
  std::string raw = ReadFile(path);
  if (raw.empty()) return spec;
  egpu::JsonPtr root = egpu::Json::Parse(raw);
  if (!root || !root->is_object()) return spec;
  egpu::JsonPtr paths = root->get("device_paths");
  egpu::JsonPtr chips = root->get("chip_indexes");
  if (paths && paths->is_array()) {
    for (auto& p : paths->items) spec.device_paths.push_back(p->str_or(""));
  } else if (chips && chips->is_array()) {
    // a card's index is its node's minor
    for (auto& c : chips->items)
      spec.device_paths.push_back("/dev/nvidia" +
                                  std::to_string(c->int_or(-1)));
  }
  egpu::JsonPtr control = root->get("control_paths");
  if (control && control->is_array())
    for (auto& p : control->items) spec.control_paths.push_back(p->str_or(""));
  egpu::JsonPtr env = root->get("env");
  if (env && env->is_object())
    for (auto& kv : env->members) spec.env[kv.first] = kv.second->str_or("");
  spec.valid = !spec.device_paths.empty();
  return spec;
}

// minor -> "GPU-<uuid>" from <proc_root>/driver/nvidia/gpus/*/information
std::map<int, std::string> UuidsByMinor(const std::string& proc_root) {
  std::map<int, std::string> out;
  std::string dir = proc_root + "/driver/nvidia/gpus";
  DIR* d = opendir(dir.c_str());
  if (!d) return out;
  struct dirent* ent;
  while ((ent = readdir(d)) != nullptr) {
    if (ent->d_name[0] == '.') continue;
    std::ifstream f(dir + "/" + ent->d_name + "/information");
    std::string line, uuid;
    int minor = -1;
    while (std::getline(f, line)) {
      size_t colon = line.find(':');
      if (colon == std::string::npos) continue;
      std::string key = line.substr(0, colon);
      std::string value = line.substr(colon + 1);
      value.erase(0, value.find_first_not_of(" \t"));
      value.erase(value.find_last_not_of(" \t\r") + 1);
      if (key == "GPU UUID") uuid = value;
      if (key == "Device Minor") minor = atoi(value.c_str());
    }
    if (minor >= 0 && !uuid.empty()) out[minor] = uuid;
  }
  closedir(d);
  return out;
}

// The stdout of argv (run without a shell, stderr dropped); "" when it
// cannot run or exits non-zero.
std::string RunCapture(const std::vector<std::string>& argv) {
  int fds[2];
  if (pipe(fds) != 0) return "";
  pid_t pid = fork();
  if (pid < 0) {
    close(fds[0]);
    close(fds[1]);
    return "";
  }
  if (pid == 0) {
    dup2(fds[1], 1);
    int null_fd = open("/dev/null", O_WRONLY);
    if (null_fd >= 0) dup2(null_fd, 2);
    close(fds[0]);
    close(fds[1]);
    std::vector<char*> cargs;
    for (auto& a : argv) cargs.push_back(const_cast<char*>(a.c_str()));
    cargs.push_back(nullptr);
    execvp(cargs[0], cargs.data());
    _exit(127);
  }
  close(fds[1]);
  std::string out;
  char buf[65536];
  ssize_t n;
  while ((n = read(fds[0], buf, sizeof(buf))) > 0) out.append(buf, n);
  close(fds[0]);
  int status = 0;
  waitpid(pid, &status, 0);
  if (!WIFEXITED(status) || WEXITSTATUS(status) != 0) return "";
  return out;
}

// The text between the first <tag> and its </tag> in s, trimmed.
std::string TagText(const std::string& s, const std::string& tag) {
  size_t a = s.find("<" + tag + ">");
  if (a == std::string::npos) return "";
  a += tag.size() + 2;
  size_t b = s.find("</" + tag + ">", a);
  if (b == std::string::npos) return "";
  std::string v = s.substr(a, b - a);
  v.erase(0, v.find_first_not_of(" \t\n"));
  v.erase(v.find_last_not_of(" \t\n") + 1);
  return v;
}

// minor -> "GPU-<uuid>" from `nvidia-smi -q -x`: each <gpu ...> element's
// <minor_number> and <uuid>, its <mig_devices> (which nest entries of their
// own) left out.
std::map<int, std::string> UuidsFromSmi(const std::string& smi) {
  std::map<int, std::string> out;
  std::string xml = RunCapture({smi, "-q", "-x"});
  size_t pos = 0;
  while ((pos = xml.find("<gpu ", pos)) != std::string::npos) {
    size_t end = xml.find("</gpu>", pos);
    if (end == std::string::npos) break;
    std::string block = xml.substr(pos, end - pos);
    size_t m;
    while ((m = block.find("<mig_devices>")) != std::string::npos) {
      size_t me = block.find("</mig_devices>", m);
      if (me == std::string::npos) break;
      block.erase(m, me + strlen("</mig_devices>") - m);
    }
    std::string uuid = TagText(block, "uuid");
    std::string minor = TagText(block, "minor_number");
    if (!uuid.empty() && !minor.empty() &&
        minor.find_first_not_of("0123456789") == std::string::npos)
      out[atoi(minor.c_str())] = uuid;
    pos = end;
  }
  return out;
}

// The fallback: the agent's links <dev>/elastic-tpu-<hash>-<p>, in order of
// <p>, each to a card node; the card's uuid from the driver's proc files,
// else from nvidia-smi.
AllocSpec SpecFromDevScan(const std::string& dev_dir,
                          const std::string& proc_root,
                          const std::string& smi,
                          const std::string& hash) {
  AllocSpec spec;
  std::string prefix = "elastic-tpu-" + hash + "-";
  DIR* d = opendir(dev_dir.c_str());
  if (!d) return spec;
  std::vector<std::pair<int, std::string>> found;  // (position, link)
  struct dirent* ent;
  while ((ent = readdir(d)) != nullptr) {
    std::string name = ent->d_name;
    if (name.rfind(prefix, 0) != 0) continue;
    found.emplace_back(atoi(name.c_str() + prefix.size()),
                       dev_dir + "/" + name);
  }
  closedir(d);
  std::sort(found.begin(), found.end());
  std::map<int, std::string> uuids = UuidsByMinor(proc_root);
  bool asked_smi = false;
  std::string visible;
  for (auto& [p, link] : found) {
    char target[PATH_MAX];
    ssize_t n = readlink(link.c_str(), target, sizeof(target) - 1);
    if (n < 0) continue;
    target[n] = '\0';
    std::string name = Basename(target);
    int minor = CardMinor(name);
    if (minor < 0) {
      vlog(link + " -> " + target + " is no card node; skipped");
      continue;
    }
    if (!uuids.count(minor) && !asked_smi) {
      asked_smi = true;
      for (auto& [m, u] : UuidsFromSmi(smi)) uuids.emplace(m, u);
    }
    auto it = uuids.find(minor);
    if (it == uuids.end()) {
      fprintf(stderr,
              "elastic-gpu-toolkit: no uuid for card minor %d under "
              "%s/driver/nvidia/gpus or from %s\n",
              minor, proc_root.c_str(), smi.c_str());
      return AllocSpec();
    }
    spec.device_paths.push_back("/dev/" + name);
    if (!visible.empty()) visible += ",";
    visible += it->second;
  }
  if (spec.device_paths.empty()) return spec;
  for (const char* node : kControlNodes)
    spec.control_paths.push_back(std::string("/dev/") + node);
  spec.env["CUDA_VISIBLE_DEVICES"] = visible;
  spec.valid = true;
  return spec;
}

// The host node /dev/<rel> as this process sees it.
std::string View(const std::string& dev_dir, const std::string& host_path) {
  if (host_path.rfind("/dev/", 0) == 0) return dev_dir + host_path.substr(4);
  return host_path;
}

// A character device a runtime can hand to a container: a host may hold a
// placeholder under a node's name (a regular file, or major 0).
bool IsCharDevice(const struct stat& st) {
  return S_ISCHR(st.st_mode) && major(st.st_rdev) != 0;
}

// The node at rootfs_path: mknod with the host rdev, a bind mount of the
// host node where mknod is refused.
bool InjectDevice(const std::string& view, const struct stat& st,
                  const std::string& rootfs_path) {
  if (!MkdirP(Dirname(rootfs_path), 0755)) return false;
  if (mknod(rootfs_path.c_str(), S_IFCHR | 0666, st.st_rdev) == 0) {
    vlog("mknod " + rootfs_path);
    return true;
  }
  if (errno == EEXIST) {
    struct stat cur;
    if (lstat(rootfs_path.c_str(), &cur) == 0 && S_ISCHR(cur.st_mode) &&
        cur.st_rdev == st.st_rdev)
      return true;  // idempotent re-run
    unlink(rootfs_path.c_str());
    if (mknod(rootfs_path.c_str(), S_IFCHR | 0666, st.st_rdev) == 0)
      return true;
  }
  int fd = open(rootfs_path.c_str(), O_CREAT | O_WRONLY, 0666);
  if (fd >= 0) close(fd);
  if (mount(view.c_str(), rootfs_path.c_str(), nullptr, MS_BIND, nullptr) ==
      0) {
    vlog("bind " + view + " -> " + rootfs_path);
    return true;
  }
  fprintf(stderr, "elastic-gpu-toolkit: inject %s -> %s failed: %s\n",
          view.c_str(), rootfs_path.c_str(), strerror(errno));
  return false;
}

bool CopyFile(const std::string& from, const std::string& to) {
  std::ifstream src(from, std::ios::binary);
  if (!src) return false;
  std::ofstream dst(to, std::ios::binary);
  if (!dst) return false;
  dst << src.rdbuf();
  return dst.good();
}

int Inject(const std::string& rootfs, const std::string& hash,
           const std::string& alloc_dir, const std::string& dev_dir,
           const std::string& proc_root, const std::string& smi,
           const std::vector<std::string>& driver_libs) {
  std::string spec_path = alloc_dir + "/" + Basename(hash) + ".json";
  AllocSpec spec = SpecFromFile(spec_path);
  if (!spec.valid) spec = SpecFromDevScan(dev_dir, proc_root, smi, hash);
  if (!spec.valid) {
    fprintf(stderr,
            "elastic-gpu-toolkit: no allocation found for hash %s "
            "(checked %s and %s)\n",
            hash.c_str(), alloc_dir.c_str(), dev_dir.c_str());
    return 1;
  }

  for (const std::string& path : spec.device_paths) {
    struct stat st;
    std::string view = View(dev_dir, path);
    if (stat(view.c_str(), &st) != 0 || !IsCharDevice(st)) {
      fprintf(stderr,
              "elastic-gpu-toolkit: card node %s is not a character "
              "device\n",
              view.c_str());
      return 1;
    }
    if (!InjectDevice(view, st, rootfs + path)) return 1;
  }
  for (const std::string& path : spec.control_paths) {
    struct stat st;
    std::string view = View(dev_dir, path);
    if (stat(view.c_str(), &st) != 0 || !IsCharDevice(st)) {
      vlog("control node " + view + " absent; skipped");
      continue;
    }
    if (!InjectDevice(view, st, rootfs + path)) return 1;
  }

  if (!MkdirP(rootfs + "/run/elastic-tpu", 0755)) return 1;
  std::ofstream envf(rootfs + "/run/elastic-tpu/env");
  for (auto& [k, v] : spec.env) envf << k << "=" << v << "\n";
  envf.close();
  if (!envf) return 1;
  CopyFile(spec_path, rootfs + "/run/elastic-tpu/alloc.json");

  for (const std::string& lib : driver_libs) {
    struct stat lst;
    std::string dst = rootfs + lib;
    if (stat(dst.c_str(), &lst) == 0 || stat(lib.c_str(), &lst) != 0)
      continue;  // the image has it, or the host lacks it
    MkdirP(Dirname(dst), 0755);
    if (CopyFile(lib, dst)) {
      chmod(dst.c_str(), 0755);
      vlog("installed " + lib);
    }
  }
  vlog("injected " + std::to_string(spec.device_paths.size()) +
       " card(s) for " + hash);
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  std::string cmd = argc > 1 ? argv[1] : "";
  std::string rootfs, hash;
  std::string alloc_dir = "/var/lib/elastic-tpu/alloc";
  std::string dev_dir = "/dev";
  std::string proc_root = "/proc";
  std::string smi = "nvidia-smi";
  std::vector<std::string> driver_libs;
  for (int i = 2; i < argc; i++) {
    std::string a = argv[i];
    auto next = [&](const char* flag) -> std::string {
      if (i + 1 >= argc) {
        fprintf(stderr, "missing value for %s\n", flag);
        exit(2);
      }
      return argv[++i];
    };
    if (a == "--rootfs") rootfs = next("--rootfs");
    else if (a == "--hash") hash = next("--hash");
    else if (a == "--alloc-dir") alloc_dir = next("--alloc-dir");
    else if (a == "--dev") dev_dir = next("--dev");
    else if (a == "--proc-root") proc_root = next("--proc-root");
    else if (a == "--nvidia-smi") smi = next("--nvidia-smi");
    else if (a == "--driver-lib") driver_libs.push_back(next("--driver-lib"));
    else if (a == "--verbose") g_verbose = true;
    else {
      fprintf(stderr, "unknown flag %s\n", a.c_str());
      return 2;
    }
  }
  if (cmd != "inject" || rootfs.empty() || hash.empty()) {
    fprintf(stderr,
            "usage: elastic-gpu-container-toolkit inject --rootfs DIR "
            "--hash H [--alloc-dir DIR] [--dev DIR] [--proc-root DIR] "
            "[--nvidia-smi PATH] [--driver-lib PATH]... [--verbose]\n");
    return 2;
  }
  return Inject(rootfs, hash, alloc_dir, dev_dir, proc_root, smi,
                driver_libs);
}
